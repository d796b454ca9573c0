"""The pool of maps: every seed assembles the same maps, in an order of its
own, and each job is judged against the reference of the map it ran on."""

import os

import pytest

from conftest import SMALL

SEEDS = (0, 5, 2 ** 31 + 77, 4300000005, 9876543210)


def small_recipe(workload="hic3k_hmm.assemble"):
    import run

    _, config, *_ = run.cell(workload)
    config["genome"].update(SMALL[workload])
    return config


def test_every_seed_assembles_the_same_maps():
    import genome

    recipe = small_recipe()["genome"]
    maps = recipe["map_seeds"]
    orders = [genome.pool(recipe, s) for s in SEEDS]
    assert all(sorted(o) == sorted(maps) for o in orders)
    assert len({tuple(o) for o in orders}) > 1
    assert genome.pool(recipe, 5) == genome.pool(recipe, 5)
    assert genome.pool(dict(recipe, map_seeds=None), 5) == [5]


def test_map_seed_draws_the_map_and_seed_the_sequence(tmp_path):
    import genome

    recipe = small_recipe()["genome"]

    def files(seed, map_seed):
        paths = genome.write_hicpro(genome.make(recipe, seed, map_seed=map_seed),
                                    str(tmp_path / f"{seed}_{map_seed}"))
        return {k: open(p, "rb").read() for k, p in paths.items()}

    a, b, c = files(11, 8), files(12, 8), files(11, 9)
    for k in ("matrix", "bias", "bed", "sizes"):
        assert a[k] == b[k], k
    assert a["fasta"] != b["fasta"] and a["validpairs"] != b["validpairs"]
    assert a["matrix"] != c["matrix"] and a["fasta"] == c["fasta"]


def test_window_runs_the_inputs_in_turn(monkeypatch, tmp_path):
    import time

    import window

    seen = []

    def run_job(workdir, paths, *args, **kwargs):
        seen.append(paths["name"])
        time.sleep(0.01)
        return window.Job(0.01, {})

    monkeypatch.setattr(window, "run_job", run_job)
    inputs = [{"name": n} for n in ("x", "y", "z")]
    jobs, dirs, _, error = window.run_window(
        0.2, lambda k: str(tmp_path / str(k)), inputs, {}, [], "cpu", 10.0, pytest.fail)
    assert error is None and len(jobs) == len(dirs) >= 4
    assert seen == [inputs[k % 3]["name"] for k in range(len(seen))]


def test_each_job_is_judged_by_its_own_maps_reference(tmp_path):
    import compare
    import genome

    config = small_recipe()
    recipe = config["genome"]
    inputs, dirs = [], []
    for k, map_seed in enumerate(recipe["map_seeds"][:2]):
        paths = genome.write_hicpro(genome.make(recipe, 3, map_seed=map_seed),
                                    str(tmp_path / f"hicpro{k}"))
        inputs.append(paths)
        dirs.append(str(tmp_path / f"job{k}"))
        compare.write_outputs(compare.Reference(paths, config), os.path.join(dirs[-1], "files"))
    ok, numbers = compare.judge_runs(inputs, dirs, config)
    assert ok, numbers
    ok, numbers = compare.judge_runs(inputs, dirs[::-1], config)
    assert not ok
    assert any(numbers[k] > compare.LIMITS[k] for k in numbers), numbers
