"""Whole runs of each cell at the program's tiny sizes on the CPU (the
look for a chip skipped), sound and with the timed path broken
underneath: a sound run comes out correct, each fault the cell can have
comes out not correct."""

import time

import pytest
import torch

from port_bench.harness import result, spec


def run(cell_name, fault=None, **traffic):
    cell = spec.load_cell(cell_name)
    cell.traffic.update(traffic)
    driver = spec.driver(cell.traffic["driver"])
    out = driver.run(cell, seed=2147483650, seconds=2.0, trace=False,
                     t_start=time.time(), device="cpu", tiny=True,
                     fault=fault)
    return result.judge(out["values"], result.load_limits(cell_name))[0]


SCORES = dict(pool=32, warmup_batches=1, batch=4, check_pool=1,
              check_batches=1)
TRAIN = dict(batch=2)


def altered_audio(synths):
    for svs in synths.values():
        decode = svs.model.decode_hidden

        def flipped(*a, _decode=decode, **k):
            y = _decode(*a, **k)
            return torch.cat([-y[:1], y[1:]])
        svs.model.decode_hidden = flipped


def unchanged_state(step):
    def frozen(g, d, batch, draws):
        keep = [p.detach().clone() for s in (g, d)
                for p in s.model.parameters()]
        metrics = step(g, d, batch, draws)
        with torch.no_grad():
            for p, k in zip([p for s in (g, d) for p in s.model.parameters()],
                            keep):
                p.copy_(k)
        return metrics
    return frozen


def half_batch(step):
    def half(g, d, batch, draws):
        n = batch["phones"].shape[0] // 2
        return step(g, d, {k: v[:n] for k, v in batch.items()}, draws)
    return half


def in_the_window(fault):
    """``fault`` on every step past the first steps: what the comparison
    of the window's sampled step alone can catch."""
    def planted(step):
        broken, calls = fault(step), [0]

        def either(*a):
            calls[0] += 1
            first = calls[0] <= spec.load_traffic("b32")["first_steps"]
            return (step if first else broken)(*a)
        return either
    return planted


def test_scores_sound():
    assert run("svs_v6.scores_b16", **SCORES)


def test_scores_altered_answer():
    assert not run("svs_v6.scores_b16", altered_audio, **SCORES)


def test_train_sound():
    assert run("visinger_train.b32", **TRAIN)


@pytest.mark.parametrize("fault", [unchanged_state, half_batch,
                                   in_the_window(unchanged_state),
                                   in_the_window(half_batch)],
                         ids=["unchanged_state", "half_batch",
                              "unchanged_state_in_the_window",
                              "half_batch_in_the_window"])
def test_train_faults(fault):
    assert not run("visinger_train.b32", fault, **TRAIN)
