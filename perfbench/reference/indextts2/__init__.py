"""The plain reference of IndexTTS2 as the engine serves it: the program's
model code copied and frozen without its kernels (each module under the
program module's name; their docstrings name the JAX originals the port
follows), the benchmark's weights (`weights.py`), and a request's stages
(`pipeline.py`).  Nothing here imports the program."""
