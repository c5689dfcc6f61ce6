#!/usr/bin/env python3
"""Where the MAS kernel's cycles go, phase by phase, on one GPU.

    python3 tools/torch_mas_phase_cycles.py

Builds a copy of music_generation_tpu_torch/csrc/monotonic_align.cu into
build/ with clock64() stamps between the kernel's phases (an extra output
argument, nothing else changed), runs it on the training shape [8, 480, 64]
of chip_smoke.py, checks the path against the plain version, and prints one
JSON object: the SM clock, and for each batch item the cycles spent on the
lengths, the forward row chain, the backtrace, the path write and in total.
Fails if the kernel source no longer has the anchors the stamps go at.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

SOURCE = ROOT / "music_generation_tpu_torch" / "csrc" / "monotonic_align.cu"
OUT = ROOT / "build" / "mas_phase_cycles"
PHASES = ("lengths", "forward", "backtrace", "write", "total")

# (anchor in the kernel source, text put in its place)
EDITS = (
    ("float* __restrict__ path, int t_y, int t_x) {",
     "float* __restrict__ path, int t_y, int t_x, long long* clk) {\n"
     "  long long c0 = clock64();"),
    ("  // acc[j]: row y-1 at column",
     "  long long c1 = clock64();\n  // acc[j]: row y-1 at column"),
    ("  __syncwarp();\n\n  if (lane == 0) {",
     "  __syncwarp();\n  long long c2 = clock64();\n\n  if (lane == 0) {"),
    ("  __syncwarp();\n\n#pragma unroll 4",
     "  __syncwarp();\n  long long c3 = clock64();\n\n#pragma unroll 4"),
    ("int t_y, int t_x, cudaStream_t stream) {",
     "int t_y, int t_x, cudaStream_t stream, long long* clk) {"),
    ("(neg_cent, mask, path, t_y, t_x);",
     "(neg_cent, mask, path, t_y, t_x, clk);"),
    ("                           void* stream) {",
     "                           void* stream, void* clk_out) {\n"
     "  long long* clk = static_cast<long long*>(clk_out);"),
)
STAMP_END = (
    "  __syncwarp();\n  long long c4 = clock64();\n"
    "  if (lane == 0) {\n    long long* o = clk + 5 * blockIdx.x;\n"
    "    o[0] = c1 - c0; o[1] = c2 - c1; o[2] = c3 - c2; o[3] = c4 - c3;\n"
    "    o[4] = c4 - c0;\n  }\n")


def instrumented_source() -> str:
    src = SOURCE.read_text()
    for anchor, text in EDITS:
        if anchor not in src:
            raise RuntimeError(f"anchor not found in {SOURCE.name}: {anchor!r}")
        src = src.replace(anchor, text)
    # the stamps' end goes before the closing brace of the kernel
    launch = src.index("template <int K>\nint launch")
    close = src.rindex("}", 0, launch)
    src = src[:close] + STAMP_END + src[close:]
    return src.replace("batch, t_y, t_x, s);", "batch, t_y, t_x, s, clk);")


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_mas_phase_cycles: no CUDA device", file=sys.stderr)
        return 1
    from music_generation_tpu_torch.ops import build, maximum_path_torch
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / "monotonic_align_cycles.cu", OUT / "libmas_cycles.so"
    cu.write_text(instrumented_source())
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib),
                    str(cu)], check=True)
    fn = ctypes.CDLL(str(lib)).mas_forward
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + \
        [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int

    dev = torch.device("cuda", 0)
    b, t_y, t_x = chip_smoke.MAS_SHAPE
    neg_cent, mask, _ = chip_smoke.mas_case(dev)
    path = torch.empty_like(neg_cent)
    clk = torch.zeros(b, len(PHASES), dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    for _ in range(5):  # the last launch's stamps are kept
        if fn(neg_cent.data_ptr(), mask.data_ptr(), path.data_ptr(), b, t_y,
              t_x, stream, clk.data_ptr()):
            raise RuntimeError("instrumented kernel launch failed")
    torch.cuda.synchronize()
    if not torch.equal(path, maximum_path_torch(neg_cent, mask)):
        raise AssertionError("instrumented kernel disagrees with the plain "
                             "version")
    sm_clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(json.dumps({"shape": [b, t_y, t_x], "gpu": sm_clock,
                      "phases": PHASES, "cycles": clk.cpu().tolist()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
