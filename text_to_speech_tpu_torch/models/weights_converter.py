"""Weight transfer between models and from other frameworks' layouts.

Counterpart of ``text_to_speech_tpu/models/weights_converter.py``, on the
JAX package's trees (nested dicts of numpy arrays, flattened to ``/``-joined
paths by `weights.flatten_tree`), so that paths, mappings and results are
the JAX package's:

  - `name_based_partial_transfer_learning`: every target leaf takes the
    source leaf its normalized name matches (exactly, else by suffix, the
    first of several candidates after those of the target's shape); a
    source of another shape gives its overlapping block and the rest is
    filled by `fill_mode` (zeros by default).  This is how SV2TTS inherits
    a single-speaker Tacotron-2 whose decoder inputs are narrower: the new
    rows start at zero, so the speaker is invisible until fine-tuning;
  - `partial_transfer_learning`, by shape in traversal order;
  - `find_layers_mapping` and `describe_mapping`, the mapping and its
    report;
  - `convert_state_dict` with the ``torch_*_kernel`` layout transforms, and
    the Keras naming helpers (`convert_keras_variables`).

The mapping takes the first candidate in the source's path order, so the
result depends on that order: pass trees in the order the JAX package
holds them (a tree read from an ``.npz`` keeps the file's order).  Leaves
come back as numpy arrays.
"""

import re
import logging

import numpy as np

from ..weights import flatten_tree, unflatten_tree

logger = logging.getLogger(__name__)


def _normalize_name(name):
    name = name.lower()
    name = re.sub(r'[._/]+', '/', name)
    name = re.sub(r'(^|/)(layer|block|cell|conv|flow)[_-]?(\d+)', r'\1\2_\3', name)
    return name


def _partial_fill(target, source, fill_mode = 'zeros', rng = None):
    """Copy the overlapping sub-tensor of `source` into a `target`-shaped
    array; the remainder is filled per `fill_mode`
    ('zeros' | 'ones' | 'normal' | 'keep')."""
    if fill_mode == 'keep':
        out = np.array(target)
    elif fill_mode == 'ones':
        out = np.ones_like(target)
    elif fill_mode == 'normal':
        rng = rng or np.random.RandomState(0)
        out = rng.normal(0., 0.02, np.shape(target)).astype(np.asarray(target).dtype)
    else:
        out = np.zeros_like(target)
    slices = tuple(
        slice(0, min(s, t)) for s, t in zip(np.shape(source), np.shape(target))
    )
    out[slices] = np.asarray(source)[slices]
    return out


def find_layers_mapping(source_flat, target_flat):
    """Map each target path to candidate source paths by normalized-name
    suffix matching, then disambiguate by shape."""
    norm_sources = {}
    for path in source_flat:
        norm_sources.setdefault(_normalize_name(path), []).append(path)

    mapping = {}
    for t_path in target_flat:
        t_norm = _normalize_name(t_path)
        candidates = norm_sources.get(t_norm, [])
        if not candidates:
            # suffix match (different root prefixes)
            candidates = [
                s for norm, paths in norm_sources.items()
                if norm.endswith(t_norm) or t_norm.endswith(norm)
                for s in paths
            ]
        if len(candidates) > 1:
            t_shape = np.shape(target_flat[t_path])
            exact = [c for c in candidates if np.shape(source_flat[c]) == t_shape]
            candidates = exact or candidates
        mapping[t_path] = candidates
    return mapping


def describe_mapping(source_tree, target_tree, *, show_values = False):
    """Human-readable transfer report: one line per target path with its
    match status — 'exact' (same shape), 'partial' (sub-tensor transfer),
    'ambiguous(n)' (several candidates), or 'UNMATCHED'.  Returns the report string (also logged)
    so checkpoint-import failures can be diagnosed from the output alone."""
    source_flat = flatten_tree(source_tree)
    target_flat = flatten_tree(target_tree)
    mapping = find_layers_mapping(source_flat, target_flat)

    lines, used = [], set()
    for t_path, t_value in target_flat.items():
        cands = mapping.get(t_path, [])
        t_shape = np.shape(t_value)
        if not cands:
            status = 'UNMATCHED'
            detail = ''
        else:
            used.update(cands)
            s_shape = np.shape(source_flat[cands[0]])
            if len(cands) > 1:
                status = 'ambiguous({})'.format(len(cands))
            elif s_shape == t_shape:
                status = 'exact'
            else:
                status = 'partial'
            detail = ' <- {} {}'.format(cands[0], s_shape)
        lines.append('{:60s} {} {}{}'.format(t_path, t_shape, status, detail))
        if show_values and cands:
            v = np.asarray(source_flat[cands[0]]).reshape(-1)[:4]
            lines.append('    values: {}'.format(np.array2string(v, precision = 4)))
    unused = [s for s in source_flat if s not in used]
    if unused:
        lines.append('-- {} unused source weights:'.format(len(unused)))
        lines.extend('   {} {}'.format(s, np.shape(source_flat[s]))
                     for s in unused)
    report = '\n'.join(lines)
    logger.info('%s', report)
    return report


def name_based_partial_transfer_learning(source_tree,
                                         target_tree,
                                         *,
                                         fill_mode = 'zeros',
                                         strict = False,
                                         verbose = True):
    """Transfer every matching-by-name weight from `source_tree` into a copy
    of `target_tree`.  Shape mismatches transfer the common sub-tensor and
    fill the rest (`fill_mode`).  Returns the new target tree (same treedef,
    numpy leaves)."""
    source_flat = flatten_tree(source_tree)
    target_flat = flatten_tree(target_tree)
    mapping = find_layers_mapping(source_flat, target_flat)

    transferred, partial, missing = [], [], []
    new_flat = {}
    for t_path, t_value in target_flat.items():
        candidates = mapping.get(t_path, [])
        if not candidates:
            missing.append(t_path)
            new_flat[t_path] = t_value
            continue
        s_value = source_flat[candidates[0]]
        if np.shape(s_value) == np.shape(t_value):
            new_flat[t_path] = np.array(s_value)
            transferred.append(t_path)
        else:
            new_flat[t_path] = _partial_fill(np.asarray(t_value), np.asarray(s_value),
                                             fill_mode)
            partial.append((t_path, np.shape(s_value), np.shape(t_value)))

    if verbose:
        logger.info(
            'weight transfer: %d exact, %d partial, %d unmatched',
            len(transferred), len(partial), len(missing)
        )
        for path, s_shape, t_shape in partial:
            logger.info('  partial %s: %s -> %s', path, s_shape, t_shape)
    if strict and missing:
        raise ValueError('Unmatched target weights: {}'.format(missing))
    return unflatten_tree(new_flat)


def partial_transfer_learning(source_tree, target_tree, ** kwargs):
    """Shape-based transfer: assign source leaves to target leaves in
    traversal order when shapes line up (for architectures with different
    naming but identical layout)."""
    source_values = list(flatten_tree(source_tree).values())
    target_flat = flatten_tree(target_tree)

    new_flat, si = {}, 0
    for t_path, t_value in target_flat.items():
        placed = False
        for j in range(si, min(si + 3, len(source_values))):
            if np.shape(source_values[j]) == np.shape(t_value):
                new_flat[t_path] = np.array(source_values[j])
                si = j + 1
                placed = True
                break
        if not placed:
            new_flat[t_path] = t_value
    return unflatten_tree(new_flat)


def convert_state_dict(state_dict, pattern_map, *, transforms = None):
    """Rename an external ``name -> array`` dict into this framework's tree.

    `pattern_map`: ordered {regex: replacement} applied to every name.
    `transforms`: {regex: fn(array) -> array} (e.g. torch conv kernels
    (out, in, w) → (w, in, out) transposition).
    Unmatched names are dropped with a log line.
    """
    out = {}
    for name, value in state_dict.items():
        value = np.asarray(value)
        new_name = name
        for pattern, repl in pattern_map.items():
            new_name = re.sub(pattern, repl, new_name)
        if transforms:
            for pattern, fn in transforms.items():
                if re.search(pattern, name):
                    value = fn(value)
        if new_name == name and not any(re.search(p, name) for p in pattern_map):
            logger.debug('state_dict name unmapped: %s', name)
        out[new_name] = value
    return unflatten_tree(out)


# -- torch layout transforms ---------------------------------------------------

def torch_conv1d_kernel(value):
    """torch Conv1d weight (out, in, w) → (w, in, out)."""
    return np.transpose(value, (2, 1, 0))


def torch_dense_kernel(value):
    """torch Linear weight (out, in) → (in, out)."""
    return np.transpose(value, (1, 0))


def torch_lstm_kernel(value, units = None):
    """torch LSTM weight_ih (4u, in) with gate order i,f,g,o → (in, 4u)."""
    return np.transpose(value, (1, 0))


# -- Keras / TF2 naming conventions --------------------------------------------
#
# Keras checkpoints (``ckpt.weights.h5``, or TF checkpoints).  Keras tensor
# layouts already match the JAX package's trees — Dense (in, out), Conv1D
# (w, in, out), LSTM kernel (in, 4u) with gate order i,f,c,o ≡ i,f,g,o — so
# the conversion is a naming problem: normalize the variable paths of a
# Keras Tacotron-2 onto the tree paths, shift 1-indexed conv/norm stacks to
# 0-indexed, and split batch-norm moving statistics into the ``state`` tree.

def normalize_keras_name(name):
    """Canonicalize a Keras/TF variable path: strip TF-checkpoint suffixes
    (``.ATTRIBUTES/VARIABLE_VALUE``), lowercase, '/'-separate, and drop a
    leading model-name component (e.g. ``tacotron2/``)."""
    name = name.replace('/.ATTRIBUTES/VARIABLE_VALUE', '')
    name = name.replace('.ATTRIBUTES/VARIABLE_VALUE', '')
    name = re.sub(r'^model/', '', name)
    name = name.lower().replace('.', '/')
    name = re.sub(r'^(tacotron2|sv2tts[a-z0-9_]*)/', '', name)
    return name


def _bn_var(name):
    return 'moving_var' if name == 'moving_variance' else name


#: Ordered regex -> replacement map: Keras Tacotron-2 variable paths (conv
#: stacks 1-indexed ``conv_{i}`` / ``norm_{i}``) -> the JAX package's
#: ``models.tacotron2_arch`` tree paths.
#: Every pattern consumes the WHOLE normalized name and emits the absolute
#: target path; application is first-match-wins.
KERAS_TACOTRON2_PATTERNS = {
    # embeddings: '<name>_embeddings/embeddings'
    r'^.*embeddings/embeddings$': lambda m: 'encoder/embedding/embeddings',
    # SV2TTS speaker concat projections
    r'^.*embedding_(projection|resizing)/(kernel|bias)$':
        lambda m: 'encoder/speaker_projection/{}'.format(m.group(2)),
    # encoder conv stack (1-indexed) + norms
    r'^.*encoder/conv_(\d+)/(kernel|bias)$':
        lambda m: 'encoder/conv_{}/conv/{}'.format(int(m.group(1)) - 1, m.group(2)),
    r'^.*encoder/norm_(\d+)/(gamma|beta|moving_mean|moving_variance)$':
        lambda m: 'encoder/conv_{}/bn/{}'.format(
            int(m.group(1)) - 1, _bn_var(m.group(2))),
    # BiLSTM flatten layer
    r'^.*bidirectional[^/]*/forward_[^/]*/(lstm_cell[^/]*/)?'
    r'(kernel|recurrent_kernel|bias)$':
        lambda m: 'encoder/bilstm/forward/{}'.format(m.group(2)),
    r'^.*bidirectional[^/]*/backward_[^/]*/(lstm_cell[^/]*/)?'
    r'(kernel|recurrent_kernel|bias)$':
        lambda m: 'encoder/bilstm/backward/{}'.format(m.group(2)),
    # decoder cell
    r'^.*attention_rnn/(lstm_cell[^/]*/)?(kernel|recurrent_kernel|bias)$':
        lambda m: 'decoder/attention_rnn/{}'.format(m.group(2)),
    r'^.*decoder_rnn/(stacked_rnn_cells[^/]*/)?cell_(\d+)/(lstm_cell[^/]*/)?'
    r'(kernel|recurrent_kernel|bias)$':
        lambda m: 'decoder/decoder_rnn/cell_{}/{}'.format(m.group(2), m.group(4)),
    # location-sensitive attention
    r'^.*query_layer/kernel$': lambda m: 'decoder/attention/query/kernel',
    r'^.*memory_layer/kernel$': lambda m: 'decoder/attention/memory/kernel',
    r'^.*value_layer/kernel$': lambda m: 'decoder/attention/value/kernel',
    r'^.*location_layer/location_conv/kernel$':
        lambda m: 'decoder/attention/location_conv/kernel',
    r'^.*location_layer/location_dense/kernel$':
        lambda m: 'decoder/attention/location_dense/kernel',
    # prenet (0-indexed 'layer_{i}')
    r'^.*prenet/layer_(\d+)/(kernel|bias)$':
        lambda m: 'decoder/prenet/layer_{}/{}'.format(m.group(1), m.group(2)),
    # output projections
    r'^.*linear_projection/(kernel|bias)$':
        lambda m: 'decoder/linear_projection/{}'.format(m.group(1)),
    r'^.*gate_output/(kernel|bias)$':
        lambda m: 'decoder/gate_layer/{}'.format(m.group(1)),
    # postnet conv stack (1-indexed)
    r'^.*postnet/conv_(\d+)/(kernel|bias)$':
        lambda m: 'postnet/conv_{}/conv/{}'.format(int(m.group(1)) - 1, m.group(2)),
    r'^.*postnet/norm_(\d+)/(gamma|beta|moving_mean|moving_variance)$':
        lambda m: 'postnet/conv_{}/bn/{}'.format(
            int(m.group(1)) - 1, _bn_var(m.group(2))),
}


def apply_keras_patterns(variables, pattern_map = None):
    """Rename a Keras-convention ``{path: array}`` dict into this framework's
    flat paths (no layout transforms -- Keras layouts already match).  Names
    matching no pattern pass through verbatim (already-canonical paths);
    application is first-match-wins per name."""
    pattern_map = pattern_map or KERAS_TACOTRON2_PATTERNS
    out, origins = {}, {}
    for name, value in variables.items():
        new_name = normalize_keras_name(name)
        for pattern, repl in pattern_map.items():
            m = re.match(pattern, new_name)
            if m:
                new_name = repl(m)
                break
        if new_name in out:
            logger.warning('keras pattern collision: %s and %s both map to %s',
                           name, origins[new_name], new_name)
        out[new_name] = np.asarray(value)
        origins[new_name] = name
    return out


def split_params_state(flat):
    """Split a flat ``path -> array`` dict into (params, state) trees:
    batch-norm moving statistics (``moving_mean`` / ``moving_var``) live in
    the separate ``state`` tree (this framework keeps apply fns pure)."""
    params_flat, state_flat = {}, {}
    for path, value in flat.items():
        (state_flat if path.rsplit('/', 1)[-1] in ('moving_mean', 'moving_var')
         else params_flat)[path] = value
    return unflatten_tree(params_flat), unflatten_tree(state_flat)


def convert_keras_variables(variables, pattern_map = None):
    """Keras/TF2-convention ``{var_path: array}`` → (params, state) pytrees.

    Covers Keras-3 ``.path`` style names and TF-checkpoint names with
    ``.ATTRIBUTES/VARIABLE_VALUE`` suffixes."""
    return split_params_state(apply_keras_patterns(variables, pattern_map))
