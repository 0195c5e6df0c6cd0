"""The transformer zoo: the generic stack with KV-cached attention
(`transformer_arch`, `attention`), generation (`generation_utils`), the
HuggingFace families and importers (`families`) and the BERT task heads
(`heads`), with the JAX package's names."""

from .transformer_arch import (
    Transformer, HParamsTransformer, sinusoidal_embedding,
    moe_load_balancing_loss,
)
from .attention import (
    init_mha, mha, rope, init_kv_cache, build_padding_mask,
    build_look_ahead_mask, combine_masks,
)
from .generation_utils import generate, beam_search, process_logits, InferenceOutput
from .families import (
    from_hf_pretrained, get_family, gpt2_config, bert_config, mistral_config,
    mixtral_config, bart_config, whisper_config, t5_config, xlm_roberta_config,
    convert_gpt2_state_dict, convert_bert_state_dict, convert_mistral_state_dict,
    convert_mixtral_state_dict,
)
from .heads import (
    init_pooler, pooler, init_mlm_head, mlm_logits, init_classifier_head,
    classify, init_qa_head, qa_spans, init_embedding_head, embed_sentences,
    convert_bert_mlm_state_dict, convert_bert_classifier_state_dict,
    convert_bert_qa_state_dict, convert_dpr_state_dict,
)
