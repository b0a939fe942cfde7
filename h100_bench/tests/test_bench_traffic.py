"""The traffic generator and the plaquette model's baths: seeded,
symmetric, in the solver's layout."""
import numpy as np

import bench_helpers
import harness
import traffic

MODEL = harness.load_module(bench_helpers.BENCH, "models", "replica_hubbard")
CONFIG = {"bath": {"levels": [-1.0, 0.0, 1.0], "v": [0.5, 0.5, 0.5]}}


def take(seed, n=4):
    gen = traffic.baths(MODEL, CONFIG, 0.1, seed)
    return [next(gen) for _ in range(n)]


def test_same_seed_same_baths_and_other_seeds_differ():
    big = 2 ** 33 + 12345                  # more than 32 signed bits
    a, b = take(big), take(big)
    c = take(big + 1)
    assert a == b
    assert not np.allclose(a[0]["levels"], c[0]["levels"])
    assert not np.allclose(a[0]["v"], c[0]["v"])
    # every solve of a run gets a new bath
    assert len({tuple(x["v"]) for x in a}) == len(a)


def test_mirror_pairs_stay_mirrored_within_the_amplitude():
    for bath in take(7, 50):
        lev, v = np.array(bath["levels"]), np.array(bath["v"])
        assert lev[0] == -lev[2] and lev[1] == 0.0
        assert v[0] == v[2]
        assert np.all(np.abs(np.abs(lev[[0, 2]]) - 1.0) <= 0.1 + 1e-15)
        assert np.all(np.abs(v / 0.5 - 1.0) <= 0.1 + 1e-15)


def test_packed_bath_matches_the_solvers_layout():
    from cdmft_lanc_ed_torch import EDConfig
    from cdmft_lanc_ed_torch.bath import DmftBath, pack_dmft_bath
    cfg = EDConfig(nlat=4, norb=1, nspin=1, nbath=3, uloc=[4.0])
    lev, v = np.array([-1.05, 0.0, 1.05]), np.array([0.48, 0.51, 0.48])
    want = pack_dmft_bath(cfg, DmftBath(v=np.tile(v[:, None], (1, 4)),
                                        lam=lev[:, None]))
    got = MODEL.bath_array(None, {"levels": lev.tolist(), "v": v.tolist()})
    assert np.array_equal(got, want)


def test_a_pool_gives_every_seed_the_same_baths_in_another_order():
    pool = {"size": 2, "seed": 16088}
    runs = []
    for seed in (2 ** 33 + 1, 2 ** 33 + 2, 2 ** 33 + 3, 2 ** 33 + 4):
        gen = traffic.baths(MODEL, CONFIG, 0.1, seed, pool)
        runs.append([tuple(next(gen)["v"]) for _ in range(4)])
    assert all(sorted(r[:2]) == sorted(runs[0][:2]) for r in runs)
    assert all(sorted(r[2:]) == sorted(runs[0][:2]) for r in runs)
    assert len({r[0] for r in runs}) == 2       # the order follows the seed
