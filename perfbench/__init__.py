"""The benchmark of the PyTorch and CUDA port (`run.py`)."""
