#!/usr/bin/env python3
"""Time ablated copies of the hand-written kernels on one NVIDIA card, to
show what bounds each.

    python3 kernel_ablation.py [--out results.json]

Each ablation takes one part out of a copy of a kernel's source (its
arithmetic or tensor-core products, its global loads, its epilogue or
stores, all work after the launch), builds the copy with the package's
nvcc flags, and times it warm and cold (chip_smoke.py's timers) at the
main path's shape, in turns with the unchanged kernel. What a part costs,
where it does not overlap with the rest, is the unchanged time less the
ablated one. Ablated kernels compute wrong votes: only their times are
read. Exits non-zero without a card. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parent
CSRC = REPO / "deep_active_semantic_segmentation_torch" / "csrc"

# source -> ablation -> [(text in the source, its replacement)]; each text
# must occur exactly once, or the run stops (``patched``) before it times
# anything: an edit of a kernel line that an anchor names needs the anchor
# edited too
ABLATIONS = {
    "upsample_argmax": {
        "no_arithmetic": [(
            "      const int cls = c0 + c;\n",
            "      const int cls = c0 + c;\n"
            "      arg[0] += __float_as_int(x00 + x01 + x10 + x11);\n"
            "      continue;\n")],
        "no_loads": [(
            "      dst[lane] = load_f32(src + min(i0 + lane, w - 1));\n"
            "      if (lane == 0) dst[kTileCols] = load_f32(src + min(i0 + kTileCols, w - 1));\n",
            "      dst[lane] = (float)(c * 7 + r + lane);\n"
            "      if (lane == 0) dst[kTileCols] = 1.0f;\n")],
        "no_stores": [(
            "  // the warp's 4 output rows, 128 columns each, through shared memory\n",
            "  int sum = 0;\n"
            "  for (int k = 0; k < 16; ++k) sum += arg[k];\n"
            "  if (sum == 123456789) out[0] = sum;\n"
            "  return;\n")],
        "launch_only": [(
            "  float best[16];\n",
            "  if (C > 0) return;\n"
            "  float best[16];\n")],
    },
    "tconv_votes": {
        "no_tensor_ops": [(
            "        if (kSplitA) wgmma_tf32<NT>(d, alo[o], bh);\n"
            "        wgmma_tf32<NT>(d, ahi[o], bl);\n"
            "        wgmma_tf32<NT>(d, ahi[o], bh);\n",
            "        (void)bh, (void)bl;\n")],
        "no_loads": [(
            "      v[k] = ok ? load_f32(xb + ci * plane + (int64_t)(i0 + r) * w + j0 + col) : 0.0f;\n",
            "      v[k] = ok ? 0.5f * e : 0.0f;\n")],
        "no_epilogue": [(
            "    // epilogue: lane (g, t) holds",
            "    {\n"
            "      float sum = 0.0f;\n"
            "      for (int p = 0; p < 4; ++p)\n"
            "        for (int nt = 0; nt < NT; ++nt)\n"
            "          for (int e = 0; e < 4; ++e) sum += acc[p][nt][e];\n"
            "      if (i0 + warp < h && j0 + g < w)\n"
            "        out[((int64_t)b * 4 + t) * plane + (int64_t)(i0 + warp) * w + j0 + g] =\n"
            "            __float_as_int(sum) & 7;\n"
            "      continue;\n"
            "    }\n"
            "    // epilogue: lane (g, t) holds")],
        "weight_staging_only": [(
            "  const int64_t plane = (int64_t)h * w;\n"
            "  for (int64_t tile",
            "  if (Cin > 0) return;\n"
            "  const int64_t plane = (int64_t)h * w;\n"
            "  for (int64_t tile")],
        "launch_only": [(
            "  // the weight, split: B(k, n)",
            "  if (Cin > 0) return;\n"
            "  // the weight, split: B(k, n)")],
    },
}

KERNEL_OF = {"upsample_argmax": "upsample4_argmax",
             "tconv_votes": "tconv2x_argmax_parity_major"}


def patched(source: str, patches) -> str:
    """``source`` with every (text, replacement) applied; each text must
    occur exactly once."""
    for text, replacement in patches:
        count = source.count(text)
        if count != 1:
            raise ValueError(f"ablation anchor found {count} times: {text[:60]!r}")
        source = source.replace(text, replacement)
    return source


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("kernel_ablation: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from deep_active_semantic_segmentation_torch import cuda_build

    card = cs.card_line()
    print(card, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, C, h, w = 5, cs.NUM_CLASSES, 129, 129
    xu = torch.randn((B, C, h, w), device="cuda", generator=gen)
    outu = torch.empty((B, 4 * (h - 1) + 1, 4 * (w - 1) + 1), dtype=torch.int32,
                       device="cuda")
    Bt, Cin, ht, wt = 8, 16, 256, 256
    xt = torch.randn((Bt, Cin, ht, wt), device="cuda", generator=gen)
    weight = torch.randn((Cin, C, 3, 3), device="cuda", generator=gen) / 4.0
    outt = torch.empty((Bt, 4, ht, wt), dtype=torch.int32, device="cuda")

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def call(source, fns):
        fn = fns[KERNEL_OF[source]][torch.float32]
        if source == "upsample_argmax":
            return lambda: fn(xu.data_ptr(), outu.data_ptr(), B, C, h, w, stream())
        return lambda: fn(xt.data_ptr(), weight.data_ptr(), outt.data_ptr(),
                          Bt, Cin, ht, wt, C, stream())

    results, made = {}, []
    try:
        for source, ablations in ABLATIONS.items():
            variants = {"unchanged": []} | ablations
            fns = {}
            for name, patches in variants.items():
                tree = Path(tempfile.mkdtemp(prefix=".chip_smoke_ablation_", dir=REPO))
                made.append(tree)
                csrc = tree / "deep_active_semantic_segmentation_torch" / "csrc"
                csrc.mkdir(parents=True)
                for other in cuda_build.SOURCES:
                    text = (CSRC / f"{other}.cu").read_text()
                    if other == source:
                        text = patched(text, patches)
                    (csrc / f"{other}.cu").write_text(text)
                fns[name] = call(source, cs.old_kernels(tree))
            rows = {}
            for name in [*variants, "unchanged"]:  # the unchanged kernel first and last
                warm, cold = cs.warm_ms(fns[name]), cs.cold_ms(fns[name])
                rows.setdefault(name, []).append({"warm_ms": warm, "cold_ms": cold})
                print(f"{source} {name}: warm {warm:.5f} ms, cold {cold:.5f} ms",
                      flush=True)
            results[source] = rows
    finally:
        for tree in made:
            shutil.rmtree(tree, ignore_errors=True)

    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"card": card, "ablations": results},
                                             indent=1))
    print(card, flush=True)
    print(json.dumps({"ablations": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
