"""Command-line synthesis on the PyTorch port (`voice_tts_tpu/cli.py`).

    python -m voice_tts_tpu_torch.cli "text to speak" -v voice.wav -o gen.wav \
        (--random | --tiny) [--profile serving|bench] [--device cuda|cpu]
        [--emo-audio E.wav] [--emo happy] [--emo-alpha 0.8]

`--random` runs the flagship widths with random weights (the audio is
noise) in the production profile (beam-3, int8 KV; the default) or, with
`--profile bench`, the bench decode configuration; `--tiny` the tiny
config.  Loading the published checkpoints is not ported yet.
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="voice-tts-tpu-torch", description="zero-shot TTS (PyTorch port)")
    parser.add_argument("text", help="text to synthesize")
    parser.add_argument("-v", "--voice", required=True,
                        help="speaker reference audio (WAV path)")
    parser.add_argument("-o", "--output_path", default="gen.wav",
                        help="output WAV path")
    weights = parser.add_mutually_exclusive_group(required=True)
    weights.add_argument("--random", action="store_true",
                         help="flagship widths, random weights (audio is noise)")
    weights.add_argument("--tiny", action="store_true",
                         help="tiny random config (fast CPU smoke test)")
    parser.add_argument("--profile", default="serving", choices=("serving", "bench"),
                        help="'serving' (default): the production profile, "
                             "beam-3 with int8 KV; 'bench': sampling, one beam")
    parser.add_argument("--device", default="cuda", help="torch device")
    parser.add_argument("--emo-audio", default=None, help="emotion reference audio")
    parser.add_argument("--emo", default=None,
                        help="emotion label (e.g. happy / 高兴)")
    parser.add_argument("--emo-alpha", type=float, default=1.0)
    parser.add_argument("-f", "--force", action="store_true",
                        help="overwrite output if it exists")
    args = parser.parse_args(argv)

    if os.path.exists(args.output_path) and not args.force:
        print(f"ERROR: output file {args.output_path} exists "
              f"(use --force/-f to overwrite)", file=sys.stderr)
        return 1
    if not os.path.exists(args.voice):
        print(f"ERROR: voice file {args.voice} does not exist", file=sys.stderr)
        return 1

    from voice_tts_tpu_torch.text.emotion import create_emotion_vector
    from voice_tts_tpu_torch.serving.app import build_engine

    engine = build_engine(args.tiny, args.device, profile=args.profile)
    emo_vector = create_emotion_vector(args.emo, args.emo_alpha) if args.emo else None
    result = engine.infer(args.voice, args.text, args.output_path,
                          emo_audio_prompt=args.emo_audio,
                          emo_alpha=args.emo_alpha, emo_vector=emo_vector)
    m = result.metrics
    print(f"wrote {args.output_path}: {m['audio_length']:.2f}s audio in "
          f"{m['inference_time']:.2f}s (RTF {m['rtf']:.3f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
