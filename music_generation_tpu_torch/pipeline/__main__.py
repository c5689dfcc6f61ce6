"""CLI: synthesize a song from lyrics, from a keyword through the T5 LM, or
one pipe-format score line.

Twin of music_generation_tpu/pipeline/__main__.py. Examples:
  python -m music_generation_tpu_torch.pipeline out.wav --text "你好世界。小小的天"
  python -m music_generation_tpu_torch.pipeline out.wav --keyword 夏天 --tiny --device cpu
  python -m music_generation_tpu_torch.pipeline out.wav --score "t|啊|C4|0.5" --tiny --device cpu
"""

import argparse
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser(description="song synthesis CLI "
                                            "(PyTorch/CUDA)")
    p.add_argument("output", help="output WAV path")
    src = p.add_mutually_exclusive_group()
    src.add_argument("--text", help="lyrics text")
    src.add_argument("--keyword", help="theme keyword (lyrics via the T5 LM; "
                                       "parity: melody_generate_with_keywords_v2)")
    src.add_argument("--score", help="pipe-format score line "
                                     "(name|lyrics|pitches|durations)")
    p.add_argument("--singer-id", type=int, default=0)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises when no GPU is "
                        "present)")
    args = p.parse_args(argv)
    if not args.text and not args.keyword and not args.score:
        p.error("need --text, --keyword or --score")

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ..audio.wav import normalize_int16, write_wav
    from .synthesis import build_default_song_synthesizer

    t0 = time.time()
    synth = build_default_song_synthesizer(tiny=args.tiny, n_speakers=1,
                                           device=args.device)
    print(f"models ready in {time.time() - t0:.1f}s", file=sys.stderr)

    t0 = time.time()
    if args.score:
        wav = synth.synthesizers[0].synthesize_pipe_format(args.score)
        write_wav(args.output, normalize_int16(wav))
    else:
        text = args.text
        if not text:
            from ..models.lyrics import build_lyric_generator
            text = build_lyric_generator(
                "t5", tiny=args.tiny,
                device=args.device).generate(args.keyword)
            print(f"lyrics: {text}", file=sys.stderr)
        result = synth.synthesize_song(text, singer_id=args.singer_id)
        with open(args.output, "wb") as f:
            f.write(result.wav_bytes)
    print(f"synthesized in {time.time() - t0:.2f}s -> {args.output}",
          file=sys.stderr)


if __name__ == "__main__":
    main()
