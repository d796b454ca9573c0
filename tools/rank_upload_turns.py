#!/usr/bin/env python3
"""Times part 1's rank-matrix upload alone on one CUDA card, with the new
copies and the parent's, each in a fresh process.

    python3 tools/rank_upload_turns.py [N]

Part 1's ``breakpoints.RankCounts`` places its int32 host rank matrix on
the card as int16 blocks through ``parallel.mesh.place_blocks``, which
copies through ``utils/transfer.copy_into``: pinned 16 MiB blocks, the cast
done on the host.  The parent's copy (``chip_smoke.parent_copies``) is one
pageable ``copy_`` with the cast on the card.  For each of old, new, new,
old this starts a process that makes a random N x N int32 matrix (default
17,162, the 16K genome's bins; the copy does not depend on the values),
reaches the card, and places the matrix twice: "cold" is the process's
first placement, which pays for its pinned blocks as a CLI run's part 1
does, "warm" the second, from the caching host allocator.  Each time is on
the host clock, from a synchronized card to the end of the copies.  Both
placements must equal the matrix.  The last line is a JSON object of every
run's times.
"""

import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

TURNS = ("old", "new", "new", "old")


def one(mode, n, device="cuda"):
    """One process's two placements under ``mode``'s copies: (cold s, warm s)."""
    import numpy as np
    import torch

    from hic_genome_assembler_tpu_torch.cluster import breakpoints

    mat = np.random.default_rng(0).integers(0, n, (n, n), dtype=np.int32)
    dev = torch.device(device)
    torch.zeros(1, device=dev)
    times = []
    for _ in range(2):
        patch = chip_smoke.parent_copies() if mode == "old" else contextlib.nullcontext()
        with patch:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rc = breakpoints.RankCounts(mat, dev)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        (block,) = rc._blocks[0]
        chip_smoke.check(block.dtype == torch.int16 and torch.equal(
            block[:n, :n].cpu(), torch.from_numpy(mat).to(torch.int16)),
            f"{mode} placement differs from the matrix")
        del rc, block
    return times


def main():
    if len(sys.argv) > 2 and sys.argv[1] == "--one":
        print(json.dumps(one(sys.argv[2], int(sys.argv[3]))))
        return
    import torch

    chip_smoke.phase_device(torch)
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 17162
    runs = []
    for k, mode in enumerate(TURNS):
        proc = subprocess.run([sys.executable, __file__, "--one", mode, str(n)],
                              capture_output=True, text=True, timeout=300)
        chip_smoke.check(proc.returncode == 0, f"run {k + 1} ({mode}) failed:\n{proc.stderr}")
        cold, warm = json.loads(proc.stdout.splitlines()[-1])
        runs.append({"run": k + 1, "copies": mode, "cold_s": cold, "warm_s": warm})
        print(f"rank upload {n} x {n}, run {k + 1} ({mode} copies) on {chip_smoke.CARD}: "
              f"cold {cold} s, warm {warm} s")
    print(json.dumps({"card": chip_smoke.CARD, "n": n, "runs": runs}))


if __name__ == "__main__":
    main()
