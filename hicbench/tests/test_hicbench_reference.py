"""The reference's batched insertion scoring (``reference._insertion_costs``)
gives the bits of the plain candidate-by-candidate scoring it replaced,
``Chromosome.costs`` over every insertion spelled out, in float64 and in
the control's float32; so the reference's files are byte for byte those of
the plain scoring."""

import filecmp
import os

import numpy as np
import pytest

from conftest import SMALL, cell

WORKLOAD = "hic16k_hypergeom.assemble"


def plain_insertion_costs(ch, order, flags, new, state, w, const):
    """Every insertion of ``new`` spelled out and scored by ``ch.costs``."""
    cand_ids, cand_e = [], []
    for slot in range(len(order) + 1):
        for o in (state, 1 - state):
            cand_ids.append(order[:slot] + [new] + order[slot:])
            cand_e.append(flags[:slot] + [o] + flags[slot:])
        state = 1 - state
    return ch.costs(np.array(cand_ids), np.array(cand_e), w, const)


@pytest.fixture(scope="module")
def small_genome(tmp_path_factory):
    """The small 16K recipe's HiC-Pro files and configuration."""
    import genome

    _, config, *_ = cell(WORKLOAD)
    config["genome"].update(SMALL[WORKLOAD])
    paths = genome.write_hicpro(genome.make(config["genome"], 4300000005),
                                str(tmp_path_factory.mktemp("hicpro")))
    return paths, config


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_insertion_costs_are_the_plain_costs_bit_for_bit(small_genome, dtype):
    import reference as ref

    paths, _ = small_genome
    inp = ref.Inputs(paths)
    rows = []
    with open(paths["bed"]) as fh:
        for line in fh:
            c = line.split("\t")
            if int(c[3]) in inp.index_of:
                rows.append((int(c[3]), c[0]))
    ch = ref.Chromosome(inp, rows, dtype)  # every scaffold in one group, as a lump
    S = len(ch.names)
    rng = np.random.default_rng(7)
    for K in range(S):
        ids = [int(x) for x in rng.permutation(S)]
        order, new = ids[:K], ids[K]
        flags = [int(x) for x in rng.integers(0, 2, K)]
        w, const = ch.weights(order + [new])
        for state in (0, 1):
            got = ref._insertion_costs(ch, order, flags, new, state, w, const)
            want = plain_insertion_costs(ch, order, flags, new, state, w, const)
            assert got.dtype == want.dtype and np.array_equal(got, want), (K, state)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_reference_files_are_the_plain_scorings(small_genome, tmp_path, monkeypatch, dtype):
    import compare
    import reference as ref

    paths, config = small_genome
    compare.write_outputs(compare.Reference(paths, config, dtype), str(tmp_path / "a" / "files"))
    monkeypatch.setattr(ref, "_insertion_costs", plain_insertion_costs)
    compare.write_outputs(compare.Reference(paths, config, dtype), str(tmp_path / "b" / "files"))
    for name in compare.JOB_FILES:
        assert filecmp.cmp(tmp_path / "a" / "files" / name, tmp_path / "b" / "files" / name,
                           shallow=False), name
    assert filecmp.cmp(os.path.join(tmp_path, "a", "log.txt"),
                       os.path.join(tmp_path, "b", "log.txt"), shallow=False)
