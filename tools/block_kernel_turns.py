#!/usr/bin/env python3
"""Times part 2's block-score kernel on one CUDA card, in a given tree.

    python3 tools/block_kernel_turns.py [TREE] [--sweep]

TREE is a checkout of this repository (default: the one holding this file).
The kernels are built with nvcc into TREE's build/kernels/.  Each time is
the device time of one call with launches queued behind a spin kernel
(``chip_smoke.queued_ms``), in ms, on integer tables of the 16K run's width
(Sp = 56, C + 1 = 769):

* the grid form (``block_scores``) at S = 8: the escalation's chunk of
  2,048 orders x 256 orientations, and its whole grid of 20,160 x 256 in
  one launch;
* the top-k form (k = 64, or 2 at S = 1), fused (``block_score_topk``,
  where TREE has it) and as two launches (``block_scores``, then
  ``group_argmax``): the one-scaffold chromosome (1 order x 2), part 2's
  only caller of it, and 20,160 orders x 512 at S = 9, a shape no caller
  reaches, kept as a measure of the sums.

``--sweep`` also times both sums (the halves tables and direct) in both
forms over 13 shapes.  To hold a change against its parent, unpack the
parent (``git archive <parent> | tar -x -C build/old``) and run the script
in turns, one process each: ``build/old``, ``.``, ``.``, ``build/old``.
The last line is a JSON object of every time, with the tree.
"""

import json
import sys
import time
from pathlib import Path

ARGS = [a for a in sys.argv[1:] if not a.startswith("--")]
TREE = Path(ARGS[0] if ARGS else Path(__file__).resolve().parent.parent).resolve()
SP, CP1 = 56, 769
CALIBRATION = ((9, 20160, 512), (9, 20160, 128), (9, 20160, 64), (8, 20160, 256),
               (8, 2048, 256), (8, 20160, 37), (8, 20160, 100), (6, 20000, 64), (6, 360, 64),
               (5, 20000, 32), (10, 4000, 1024), (10, 20000, 64), (7, 20000, 128))


def main():
    sys.path.insert(0, str(TREE))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    import chip_smoke as cs
    from hic_genome_assembler_tpu_torch.ops import _build, perms
    from hic_genome_assembler_tpu_torch.ops import score_kernels as sk

    t0 = time.time()
    _build.build()
    _build.library()
    print(f"[{TREE.name}] build {time.time() - t0:.1f} s", flush=True)
    dev = torch.device("cuda")
    rng = np.random.default_rng(5)
    sizes_np = np.zeros(SP, dtype=np.int64)
    sizes_np[: SP - 1] = rng.integers(1, 25, SP - 1)
    F = torch.from_numpy(rng.integers(0, 16, 4 * SP * SP * CP1).astype(np.float32)).to(dev)
    sizes = torch.from_numpy(sizes_np).to(dev)
    c0 = torch.tensor(7.0, device=dev)
    ids = rng.permutation(SP - 1)[:10]

    def case(S, Bo, R):
        """Bo orders of S ids (the enumeration's first, or random ones past
        it), every orientation (R = 2**S) or R random rows."""
        if S > 9 or Bo > len(perms.order_batch(S)):
            orders = np.stack([rng.permutation(ids[:S]) for _ in range(Bo)])
        else:
            orders = ids[:S][perms.order_batch(S)[:Bo]]
        orients = perms.orient_batch(S) if R == 2**S else rng.integers(0, 2, (R, S))
        return [F, sizes, torch.from_numpy(np.array(orders, np.int32)).to(dev),
                torch.from_numpy(np.array(orients, np.int32)).to(dev), c0]

    def grid(args):
        return cs.queued_ms(torch, lambda: sk.block_scores(*args))

    def topk(args, k=64):
        return cs.queued_ms(torch, lambda: sk.block_score_topk(*args, k))

    def two_launch(args, k=64):
        return cs.queued_ms(torch, lambda: sk.group_argmax(sk.block_scores(*args).reshape(-1), k))

    fused = hasattr(sk, "block_score_topk")
    out = {}
    for label, (S, Bo, R) in {"S=8 2048x256": (8, 2048, 256),
                              "S=8 20160x256": (8, 20160, 256)}.items():
        out[label] = grid(case(S, Bo, R))
    for label, (S, Bo, R) in {"S=1 1x2 top-k": (1, 1, 2),
                              "S=9 20160x512 top-k": (9, 20160, 512)}.items():
        args, k = case(S, Bo, R), min(64, Bo * R)
        out[label + " two-launch"] = two_launch(args, k)
        if fused:
            out[label] = topk(args, k)
    if "--sweep" in sys.argv:
        halves = sk.block_halves
        for S, Bo, R in CALIBRATION:
            args = case(S, Bo, R)
            for form in (True, False):
                sk.block_halves = lambda S, R, h=form: h
                out[f"S={S} {Bo}x{R} grid halves={form}"] = grid(args)
                out[f"S={S} {Bo}x{R} top-k halves={form}"] = topk(args)
        sk.block_halves = halves
    for key, ms in out.items():
        print(f"[{TREE.name}] {key}: {ms} ms")
    print(json.dumps({"tree": str(TREE), **out}))


if __name__ == "__main__":
    main()
