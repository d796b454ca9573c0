"""HMM chromosome-cut strategy (part 1's alternative to hypergeometrics).

Counterpart of ``hic_genome_assembler_tpu/cluster/hmm_cuts.py``, copied with
its logic unchanged: that module imports the JAX ``GaussianHMM2``, so it
cannot be reused.  Each search fits the port's ``GaussianHMM2`` on
``device``:

* per call: fit on rows from the last cut, columns truncated at the
  lookAhead window; boundary = first run of >= minSize consecutive
  non-start states; iterate the right edge until the cut fixpoints;
* outer loop: repeat until the last cut passes N*(1-modularity); pop
  sentinel/terminal cuts; when the HMM cuts at the matrix end and the
  remainder is >= 5x the modularity fraction, recurse with
  convergenceRounds-1 and the reference's hard-coded reset parameters
  (minSize=5, modularity=.05, lookAhead=.5).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import numpy as np

from hic_genome_assembler_tpu_torch.ops.gaussian_hmm import GaussianHMM2
from hic_genome_assembler_tpu_torch.utils import profiling


def identify_boundary(
    hidden_states: np.ndarray, cut_indices: Sequence[int], switch_count: int = 10
) -> int:
    """First index with switch_count consecutive non-start states."""
    counts = {0: 0, 1: 0}
    for s in hidden_states[:switch_count]:
        counts[int(s)] += 1
    start_state = sorted(counts.items(), key=lambda kv: kv[1], reverse=True)[0][0]
    cut_ind = 0
    for ind in range(len(hidden_states) - switch_count):
        window = hidden_states[ind : ind + switch_count]
        if all(int(h) != start_state for h in window):
            cut_ind = ind + cut_indices[-1]
            break
    return cut_ind


def hmm_chromosomes(
    adj: np.ndarray,
    cut_indices: List[int],
    min_size: int = 20,
    convergence_rounds: int = 8,
    look_ahead=False,
    seed: int = 0,
    hmm_mode: str = "fast",
    device="cpu",
) -> List[int]:
    """One boundary search from the last cut."""
    adj = np.asarray(adj)
    n = len(adj)
    if look_ahead is not False:
        look_ahead = int((float(n - cut_indices[-1]) * look_ahead) + cut_indices[-1])
    else:
        look_ahead = n

    prev_cut, round_count = look_ahead, 1
    cut_ind = prev_cut
    while round_count <= convergence_rounds:
        if (n - cut_indices[-1]) / 2 < min_size:
            cut_indices.append("NA")
            break
        X = adj[cut_indices[-1] :, cut_indices[-1] : prev_cut]
        print("Input matrix size = " + str(len(X)) + " x " + str(X.shape[1]))
        print("HMM round = " + str(round_count))
        if X.shape[1] < min_size:
            cut_ind = look_ahead
        else:
            hidden = GaussianHMM2(seed=seed, mode=hmm_mode, device=device).fit_predict(X)
            with profiling.timer("part1/hmm_boundary"):
                cut_ind = identify_boundary(hidden, cut_indices, switch_count=min_size)
        if cut_ind != prev_cut:
            prev_cut = cut_ind
            round_count += 1
            continue
        print("HMM convergence rounds = " + str(round_count))
        cut_indices.append(int(cut_ind))
        break
    if round_count > convergence_rounds:
        cut_indices.append(int(cut_ind))
        print("WARNING... HMM failed to converge after " + str(round_count) + " rounds...")
        print("Proceeding with last found cutIndex of " + str(cut_ind) + "...")
    return cut_indices


def identify_chromosome_groups_hmm(
    adj: np.ndarray,
    bin_list,
    min_size: int = 5,
    modularity: float = 0.05,
    convergence_rounds: int = 5,
    look_ahead=0.2,
    louvain_rounds: int = 20,
    prev_cut_inds: Optional[List[int]] = None,
    seed: int = 0,
    hmm_mode: str = "fast",
    device="cpu",
) -> List[int]:
    """Outer loop of the HMM cut search."""
    print("#########################\n#########################")
    print("Working on iterative 2 state HMMs to identify chromosome boundaries...")
    start_time = time.time()
    adj = np.asarray(adj)
    n = float(len(adj))
    remainder = n - (modularity * n)
    cut_indices: List = [0]
    if modularity == 1:
        return []
    if prev_cut_inds is not None:
        cut_indices = prev_cut_inds

    while cut_indices[-1] <= remainder:
        print("#########################\n#########################")
        cut_indices = hmm_chromosomes(
            adj,
            cut_indices,
            min_size=min_size,
            convergence_rounds=convergence_rounds,
            look_ahead=look_ahead,
            seed=seed,
            hmm_mode=hmm_mode,
            device=device,
        )
        print("Cut indices =  " + str(cut_indices))
        if cut_indices[-1] == 0:
            print("Algorithm terminated. No obvious chromosome boundary could be found... ")
            break
        if cut_indices[-1] == "NA":
            cut_indices.pop(-1)
            break
    if cut_indices and cut_indices[0] == 0:
        cut_indices.pop(0)
    print("#########################\n#########################")
    print("HMM rounds completed in " + str(time.time() - start_time) + " seconds")
    print(
        "Chromosome groups found via HMMs "
        + str(len(cut_indices)) + " / " + str(len(cut_indices) + 1)
    )

    if cut_indices and cut_indices[-1] == len(adj):
        print(
            "- WARNING - Last cut index found to be length of current matrix "
            "removing index values of {}".format(cut_indices[-1])
        )
        cut_indices.pop(-1)
        last = cut_indices[-1] if cut_indices else 0
        # The reference's guard reads len(matrix[0]) of a numpy.asmatrix,
        # which is 1, so it is ``remaining >= 5 * modularity``; reproduced.
        if (len(adj) - last) >= (5 * (1 * modularity)):
            print(
                "- convergenceRounds reduced from {} --> {}".format(
                    convergence_rounds, convergence_rounds - 1
                )
            )
            if convergence_rounds - 1 == 0:
                print(
                    "- Failed to converge after reducing convergence rounds all "
                    "the way to 1... Returning current indices"
                )
                return cut_indices
            print(
                "- Recursing on identifyChromosomeGroupsHMM function, due to "
                "remaining fraction of data being greater than 5x than that of "
                "desired fraction"
            )
            # the reference's hard-coded reset parameters
            cut_indices = identify_chromosome_groups_hmm(
                adj,
                bin_list,
                min_size=5,
                modularity=0.05,
                convergence_rounds=convergence_rounds - 1,
                look_ahead=0.5,
                louvain_rounds=20,
                prev_cut_inds=cut_indices if cut_indices else [0],
                seed=seed,
                hmm_mode=hmm_mode,
                device=device,
            )
    print(
        "Total time to identify chromosome boundries = "
        + str(time.time() - start_time) + " seconds"
    )
    return cut_indices
