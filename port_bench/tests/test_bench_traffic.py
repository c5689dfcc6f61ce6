"""The seeded generators: the same seed gives the same work; another seed
the same sizes in another order."""

from port_bench.drivers import gan_train, score_batches
from port_bench.harness import spec


def test_score_batches_repeat_by_seed():
    t = spec.load_traffic("scores_b16")
    a = score_batches.make_scores(t, 7, n=6)
    assert a == score_batches.make_scores(t, 7, n=6)
    b = score_batches.make_scores(t, 8, n=6)
    assert a != b
    for (sa, ba), (sb, bb) in zip(a, b):
        assert sa == sb and len(ba) == t["batch"]
        assert sorted(d for *_, d in ba) == sorted(d for *_, d in bb)
        for text, notes, durs in ba:
            assert len(text) == len(notes) == len(durs)
            assert all(t["syllable_seconds"][0] <= d <=
                       t["syllable_seconds"][1] for d in durs)


def test_train_batches_repeat_by_seed():
    cell = spec.load_cell("visinger_train.b32")
    t = gan_train.traffic_sizes(cell.traffic, tiny=True)
    svs = cell.config["tiny"]["svs"]
    a, b = gan_train.Batches(t, svs, 3), gan_train.Batches(t, svs, 3)
    x, y = a.make(1), b.make(1)
    assert all((x[k] == y[k]).all() for k in x)
    c = gan_train.Batches(t, svs, 4)
    assert sorted(a.sizes) == sorted(c.sizes) and a.sizes != c.sizes
    a.fill()
    assert all((a.make(1 + t["batches"])[k] == y[k]).all() for k in y)
    for n, f in a.items(0):
        assert t["phones"][0] <= n <= t["phones"][1] and f >= n
    assert (x["phone_durations"].sum(1) == x["y_lengths"]).all()


def test_window_probe_is_past_the_feeds_first_cycle():
    t = spec.load_traffic("b32")
    lo, hi = t["probe_steps"]
    assert t["first_steps"] + lo >= t["batches"] and hi > lo
