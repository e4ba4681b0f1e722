"""voice_tts_tpu_torch: the PyTorch + CUDA port of voice_tts_tpu.

Mirrors the JAX package's layout (`audio`, `models`, `ops`, `engine`,
`serving`, `utils`) and its module names, so each module's counterpart is
easy to find.  It imports `torch`, never `jax`, `flax` or `pydantic`, and
nothing of the JAX package: `config`, `logging` and `text` are the port's
own copies of the JAX package's modules of those names.  The kernels the
JAX package wrote in Pallas for the TPU are hand-written CUDA here
(`csrc/`, built at first use by `ops.build`).
"""
