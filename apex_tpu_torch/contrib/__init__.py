"""Counterpart of ``apex_tpu.contrib``: the subpackages ported so far
(``xentropy``, ``group_norm``, ``multihead_attn``, ``sparsity``). Import
them explicitly, as with the reference's optional builds."""
