# Low-level image ops, composed from XLA primitives.
# Submodules are imported lazily by users to keep import cost down:
#   from livevisionkit_tpu.ops import color, resample, remap
