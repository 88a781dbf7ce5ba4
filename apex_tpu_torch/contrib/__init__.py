"""Counterpart of ``apex_tpu.contrib``: the subpackages ported so far
(``xentropy``). Import them explicitly, as with the reference's optional
builds."""
