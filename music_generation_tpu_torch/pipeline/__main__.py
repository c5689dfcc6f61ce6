"""CLI: synthesize a song from lyrics, or from a keyword through the T5 LM.

Twin of music_generation_tpu/pipeline/__main__.py (its --score mode is not
ported yet). Examples:
  python -m music_generation_tpu_torch.pipeline out.wav --text "你好世界。小小的天"
  python -m music_generation_tpu_torch.pipeline out.wav --keyword 夏天 --tiny --device cpu
"""

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description="song synthesis CLI "
                                            "(PyTorch/CUDA)")
    p.add_argument("output", help="output WAV path")
    p.add_argument("--text", help="lyrics text")
    p.add_argument("--keyword", help="theme keyword (lyrics via the T5 LM; "
                                     "parity: melody_generate_with_keywords_v2)")
    p.add_argument("--singer-id", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises when no GPU is "
                        "present)")
    args = p.parse_args(argv)
    if not args.text and not args.keyword:
        p.error("need --text or --keyword")

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from .synthesis import build_default_song_synthesizer

    t0 = time.time()
    synth = build_default_song_synthesizer(tiny=args.tiny, n_speakers=1,
                                           device=args.device)
    print(f"models ready in {time.time() - t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    text = args.text
    if not text:
        from ..models.lyrics import build_lyric_generator
        text = build_lyric_generator("t5", tiny=args.tiny,
                                     device=args.device).generate(args.keyword)
        print(f"lyrics: {text}", file=sys.stderr)
    result = synth.synthesize_song(text, singer_id=args.singer_id)
    with open(args.output, "wb") as f:
        f.write(result.wav_bytes)
    print(f"synthesized in {time.time() - t0:.2f}s -> {args.output}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
