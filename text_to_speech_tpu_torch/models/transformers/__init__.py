"""Transformer building blocks: the self-attention (`attention.mha`) and the
sinusoidal position table (`transformer_arch.sinusoidal_embedding`) that
FastSpeech-2 uses; the JAX package's transformer families are not ported."""
