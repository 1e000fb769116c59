"""The traffic generator repeats from its seed, gives the cells' sizes, and
finds each family by name."""

import numpy as np
import pytest

from gnnbench import counts, generate

SEED = 2 ** 40 + 12345


def same(a, b):
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("mix", ["routes_118", "routes_28"])
def test_repeats_from_its_seed(mix):
    m = generate.load_mix(mix)
    assert same(generate.batch(m, SEED, 1), generate.batch(m, SEED, 1))
    assert not same(generate.batch(m, SEED, 1), generate.batch(m, SEED + 1, 1))
    assert not same(generate.batch(m, SEED, 0), generate.batch(m, SEED, 1))


@pytest.mark.parametrize("mix, links, paths", [("routes_118", 8732, 65136),
                                               ("routes_28", 2072, 15456)])
def test_routes_sizes(mix, links, paths):
    m = generate.load_mix(mix)
    raws = generate.batch(m, SEED, 0)
    assert counts.nodes(raws, "link") == links and counts.nodes(raws, "path") == paths
    # every length 2..8 as often as the batch allows: the same edges for every seed
    lengths = np.concatenate([np.bincount(r["adjacencies"]["adj_links_paths"][1]) for r in raws])
    assert lengths.min() == 2 and lengths.max() == 8
    assert np.ptp(np.bincount(lengths)[2:]) <= 1
    assert counts.edges(raws, "adj_links_paths") == counts.edges(generate.batch(m, SEED + 7, 3),
                                                                 "adj_links_paths")
    for r in raws:
        src, dst, seq = r["adjacencies"]["adj_links_paths"]
        for p in range(5):  # distinct links, in path order
            links_p = src[dst == p]
            assert len(set(links_p.tolist())) == len(links_p)
            assert np.array_equal(seq[dst == p], np.arange(len(links_p)))
        rs, rd, rq = r["adjacencies"]["adj_paths_links"]
        assert sorted(zip(rs.tolist(), rd.tolist())) == sorted(zip(dst.tolist(), src.tolist()))
        assert np.all(np.diff(rd) >= 0) and np.all(r["label"] > 0)


def test_each_family_is_a_module_found_by_name():
    from gnnbench.traffic import routes

    assert generate.family(generate.load_mix("routes_28")) is routes
    with pytest.raises(ModuleNotFoundError):
        generate.batch({"family": "no_such_family"}, SEED, 0)
    small = routes.small(generate.load_mix("routes_118"))
    raws = generate.batch(small, SEED, 0)
    assert len(raws) == small["samples_per_batch"] and counts.nodes(raws, "path") == 2 * 40
