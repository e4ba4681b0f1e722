"""Command-line micro-benchmarks of the port's kernels, run on the GPU:
`python -m voice_tts_tpu_torch.scripts.micro_tile` (K12) and
`python -m voice_tts_tpu_torch.scripts.micro_int4 --modes ...` (K13)."""
