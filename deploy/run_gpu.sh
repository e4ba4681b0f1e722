#!/usr/bin/env bash
# Launch the serving container of the PyTorch port (Dockerfile.torch) on an
# NVIDIA host: the twin of deploy/run_tpu.sh.
#
# Usage: ./deploy/run_gpu.sh [MODEL_DIR] [PORT]
set -euo pipefail

MODEL_DIR="${1:-$PWD/models}"
PORT="${2:-8000}"
IMAGE="${IMAGE:-voice-tts-tpu-torch}"
NAME="${NAME:-voice-tts-tpu-torch}"

if [ ! -d "$MODEL_DIR" ]; then
    echo "model dir $MODEL_DIR not found (convert checkpoints first:" >&2
    echo "  voice-tts-tpu-torch-convert --out DIR, see --help)" >&2
    exit 1
fi
# a bind mount needs an absolute path (a bare name would be a named volume)
MODEL_DIR="$(cd "$MODEL_DIR" && pwd)"

docker rm -f "$NAME" 2>/dev/null || true

# --gpus all exposes the cards to the container (what --privileged and the
# /dev/accel* passthrough are to the TPU image)
exec docker run -d \
    --name "$NAME" \
    --restart unless-stopped \
    --gpus all \
    -p "$PORT:8000" \
    -v "$MODEL_DIR":/models:ro \
    "$IMAGE"
