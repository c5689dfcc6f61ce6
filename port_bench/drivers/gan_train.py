"""VISinger GAN steps through the program's trainer, as its CLI runs them.

Set-up builds the training object once (``train.create_states`` and
``make_train_step``), hands it the seed's weights, and drives its first
``first_steps`` steps through the window's own call and feed (the
program's ``runtime.prefetch.Prefetcher`` with ``train.to_device``); the
window then goes on with the same object, feed and draw generator. Each
batch is the harness's: ``batch`` items whose phones and frames come from
the mix's fixed list of sizes (drawn once from ``sizes_seed``) in the
seed's order, padded to (``pad_phones``, ``pad_frames``), with noise audio
and its spectrogram, random phones, notes and F0 drawn from the seed and
the step.

End-to-end: ``train_step_ms``, the window's wall over the steps it
completed. The comparison runs the plain reference step from the same
weights, batches and generator states over the first steps: every loss
term of each step, the generator's output audio and its MAS durations,
the first gradient of every leaf (from the program's Adam state after one
step) and every leaf's change over the first steps. It also follows one
step of the window, drawn from the seed out of ``probe_steps`` (past the
feed's first cycle of ``batches``): from the program's leaves, Adam
moments and update counts before that step, its batch and generator
state, the reference takes the step, and its loss terms and each leaf's
change are compared.
"""

from __future__ import annotations

import dataclasses
import json
import math
import random
import sys
import time

import numpy as np
import torch

from ..harness import weights
from ..harness.trace import Window
from . import common



def traffic_sizes(traffic: dict, tiny: bool) -> dict:
    return {**traffic, **traffic["tiny"]} if tiny else traffic


class Batches:
    """The seed's batches: ``make(step)`` -> numpy arrays (the trainer's
    batch schema), and each step's items' (phones, frames)."""

    def __init__(self, traffic: dict, svs: dict, seed: int):
        self.t, self.svs, self.seed = traffic, svs, seed
        rng = random.Random(traffic["sizes_seed"])
        sizes = [(rng.randint(*traffic["phones"]),
                  rng.randint(*traffic["frames"]))
                 for _ in range(traffic["pool"])]
        random.Random(weights.sub_seed(seed, "train.order")).shuffle(sizes)
        self.sizes = sizes

    def items(self, step: int) -> list:
        b = self.t["batch"]
        k = step % self.t["batches"]
        return [self.sizes[(k * b + i) % len(self.sizes)] for i in range(b)]

    def make(self, step: int) -> dict:
        """Step ``step``'s batch: the ``batches`` distinct batches made in
        set-up, in turn (``fill``), or made here before ``fill``."""
        pool = getattr(self, "pool", None)
        if pool is not None:
            return pool[step % len(pool)]
        return self._make(step % self.t["batches"])

    def fill(self) -> None:
        """Make every distinct batch now (set-up), so the feed only copies
        them to the card during the window."""
        self.pool = [self._make(k) for k in range(self.t["batches"])]

    def _make(self, step: int) -> dict:
        from ..reference.audio.stft import spectrogram
        t, s = self.t, self.svs
        b, tp, fp, hop = (t["batch"], t["pad_phones"], t["pad_frames"],
                          s["hop_length"])
        rng = np.random.RandomState(
            weights.sub_seed(self.seed, f"train.batch.{step}") % 2 ** 32)
        out = {"phones": np.zeros((b, tp), np.int32),
               "x_lengths": np.zeros((b,), np.int32),
               "y_lengths": np.zeros((b,), np.int32),
               "note_ids": np.zeros((b, tp), np.int32),
               "note_durations": np.zeros((b, tp), np.float32),
               "f0_score": np.zeros((b, fp), np.int32),
               "phone_durations": np.zeros((b, tp), np.int32),
               "shengdiao": np.zeros((b, tp), np.int32),
               "audio": np.zeros((b, fp * hop, 1), np.float32),
               "log_f0": np.zeros((b, fp), np.float32)}
        for i, (n, f) in enumerate(self.items(step)):
            base = f // n
            dur = np.full(n, base, np.int32)
            dur[-1] += f - base * n
            out["phones"][i, :n] = rng.randint(3, 60, n)
            out["note_ids"][i, :n] = rng.randint(40, 80, n)
            out["shengdiao"][i, :n] = rng.randint(3, 250, n)
            out["phone_durations"][i, :n] = dur
            out["note_durations"][i, :n] = dur * s["frame_seconds"]
            out["x_lengths"][i], out["y_lengths"][i] = n, f
            out["f0_score"][i, :f] = rng.randint(1, 255, f)
            out["log_f0"][i, :f] = np.log(rng.uniform(80, 400, f))
            out["audio"][i, :f * hop, 0] = rng.uniform(-0.3, 0.3, f * hop)
        n_fft = 2 * (s["spec_channels"] - 1)
        spec = spectrogram(torch.from_numpy(out["audio"][..., 0]),
                           n_fft=n_fft, hop=hop, win_length=n_fft).numpy()
        out["spec"] = np.ascontiguousarray(spec[:, :fp], np.float32)
        return out


def reference_models(cell, seed: int, device, tiny: bool):
    from ..reference.models.svs import (MultiPeriodDiscriminator, SVSConfig,
                                        VISinger)
    sz = common.sizes(cell.config, tiny)
    scfg = common.as_config(SVSConfig, sz["svs"])
    gen = weights.build(lambda: VISinger(scfg), device, seed, "train.gen")
    disc = weights.build(lambda: MultiPeriodDiscriminator(
        tuple(sz["periods"])), device, seed, "train.disc")
    return scfg, gen, disc


class Recorder:
    """Outputs of the program's first steps: the generator's training
    forward (the second call of each step, the generator update's) and
    the loss terms."""

    def __init__(self):
        self.on = False
        self.forwards = []
        self._undo = None

    def install(self) -> None:
        from music_generation_tpu_torch.train import trainer
        fwd = trainer.gen_forward
        rec = self

        def gen_forward(*a, **k):
            out = fwd(*a, **k)
            if rec.on and torch.is_grad_enabled():
                rec.forwards.append({
                    "audio": out["audio"].detach().clone(),
                    "duration_targets": out["duration_targets"].clone()})
            return out
        self._undo = (trainer, fwd)
        trainer.gen_forward = gen_forward

    def uninstall(self) -> None:
        if self._undo is not None:
            module, fwd = self._undo
            module.gen_forward = fwd
            self._undo = None


def run(cell, seed: int, seconds: float, trace: bool, t_start: float,
        device: str = "cuda", tiny: bool = False, fault=None,
        control: bool = False) -> dict:
    """One run: build the training object, drive its first steps, measure
    ``seconds`` of steps (the mix's ``trace_seconds`` when traced, and at
    least up to the sampled step), compare the first steps and the sampled
    step. ``fault(step)`` (the CPU tests) wraps the program's step;
    ``control`` also reads the TF32 and half-batch controls."""
    from music_generation_tpu_torch.runtime.prefetch import Prefetcher
    from music_generation_tpu_torch.train import (TrainConfig,
                                                  create_states,
                                                  make_train_step, to_device)
    from music_generation_tpu_torch.train.configs import build_svs_config
    common.float32_only()
    traffic = traffic_sizes(cell.traffic, tiny)
    sz = common.sizes(cell.config, tiny)
    svs_cfg = build_svs_config(tiny=tiny)
    common.same_config(svs_cfg, sz["svs"], "svs")
    tc = common.as_config(TrainConfig, sz["train"])
    common.same_config(tc, sz["train"], "train")
    gen_state, disc_state = create_states(svs_cfg, tc, device)
    _, ref_gen, ref_disc = reference_models(cell, seed, device, tiny)
    weights.hand_over(gen_state.model, ref_gen)
    weights.hand_over(disc_state.model, ref_disc)
    del ref_gen, ref_disc
    common.free_device()
    step_fn = make_train_step(svs_cfg, tc)
    if fault is not None:
        step_fn = fault(step_fn)
    draws = weights.generator(device, seed, "train.draws")
    batches = Batches(traffic, sz["svs"], seed)
    batches.fill()
    feed = Prefetcher(batches.make, 1 << 30, depth=traffic["prefetch"],
                      transfer=lambda b: to_device(b, device))
    stream = iter(feed)
    first = traffic["first_steps"]
    probe_at = random.Random(weights.sub_seed(seed, "train.probe")).randrange(
        *traffic["probe_steps"])
    rec = Recorder()
    rec.install()
    seen = {"states": [], "metrics": [], "before": None, "moment": None}
    try:
        seen["before"] = snapshot(gen_state, disc_state)
        rec.on = True
        for k in range(first):
            seen["states"].append(draws.get_state())
            _, batch = next(stream)
            m = step_fn(gen_state, disc_state, batch, draws)
            seen["metrics"].append({n: float(v) for n, v in m.items()
                                    if v.ndim == 0})
            if k == 0:
                seen["moment"] = first_moments(gen_state, disc_state)
        rec.on = False
        seen["after"] = snapshot(gen_state, disc_state)
        probe = Probe(gen_state, disc_state)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.time() - t_start
        length = min(seconds, traffic["trace_seconds"]) if trace else seconds
        steps = 0
        with Window(trace) as w:
            deadline = w.t0 + length
            while time.time() < deadline or steps <= probe_at:
                with torch.profiler.record_function("port_bench.feed"):
                    i, batch = next(stream)
                if steps == probe_at:
                    with torch.profiler.record_function("port_bench.probe"):
                        probe.before(i, draws)
                with torch.profiler.record_function("port_bench.step"):
                    m = step_fn(gen_state, disc_state, batch, draws)
                if steps == probe_at:
                    with torch.profiler.record_function("port_bench.probe"):
                        probe.after(m)
                steps += 1
        peak = (torch.cuda.max_memory_allocated() if device == "cuda"
                else 0)
    finally:
        feed.close()
        rec.uninstall()
    window_s = w.t1 - w.t0
    counts = window_counts(batches, first, steps, sz) if trace else {}
    if w.summary is not None:
        mas = [o for o in w.summary.ops if "mas_kernel" in o.name
               or "mas_wide_kernel" in o.name]
        print(f"MAS kernels in the trace: {len(mas)} for {steps} steps "
              f"({sorted({o.name for o in mas})})", file=sys.stderr)
    seen["probe"] = probe.taken()
    del gen_state, disc_state, step_fn, probe
    common.free_device()
    t_check = time.time()
    values, controls = check(cell, seed, device, tiny, batches, seen,
                             rec.forwards, control)
    print(f"reference check: {time.time() - t_check:.1f} s",
          file=sys.stderr, flush=True)
    return {"attempted": steps, "failed": 0,
            "end_to_end": {"setup_s": setup_s,
                           "train_step_ms": 1000.0 * window_s / steps},
            "values": values, "controls": controls,
            "memory_peak_bytes": peak, "trace": w.summary,
            "ctx": common.Ctx(trace=w.summary, window_s=window_s, spans={},
                              counters={"steps": steps}, counts=counts)}


def snapshot(gen_state, disc_state) -> dict:
    return {f"{tag}.{n}": p.detach().clone()
            for tag, s in (("gen", gen_state), ("disc", disc_state))
            for n, p in s.model.named_parameters()}


class Probe:
    """Copies of the program's state around one step of the window: before
    it, what the step starts from (every leaf, its Adam moments, each
    optimizer's count of applied updates, the draw generator's state and
    the step's index); after it, every leaf and the loss terms. The
    buffers are made at set-up, so the window only copies into them."""

    def __init__(self, gen_state, disc_state):
        self.states = (("gen", gen_state), ("disc", disc_state))
        self.names, self.leaves, moments = [], [], []
        for tag, s in self.states:
            by_param = {id(p): n for n, p in s.model.named_parameters()}
            for p in s.opt.params:
                state = s.opt.adam.state[p]
                self.names.append(f"{tag}.{by_param[id(p)]}")
                self.leaves.append(p.detach())
                moments += [state["exp_avg"], state["exp_avg_sq"]]
        self.src = self.leaves + moments
        with torch.no_grad():
            self.dst = [torch.empty_like(t) for t in self.src]
            self.dst_after = [torch.empty_like(t) for t in self.leaves]
        self.info = None

    @torch.no_grad()
    def before(self, step: int, draws) -> None:
        torch._foreach_copy_(self.dst, self.src)
        self.info = {"step": step, "state": draws.get_state(),
                     "counts": {tag: s.opt.count for tag, s in self.states}}

    @torch.no_grad()
    def after(self, metrics: dict) -> None:
        torch._foreach_copy_(self.dst_after, self.leaves)
        self.info["metrics"] = {n: v.detach().clone()
                                for n, v in metrics.items() if v.ndim == 0}

    def taken(self) -> dict:
        """{"step", "state", "counts", "metrics", "before": {leaf: copy},
        "moments": {leaf: (exp_avg, exp_avg_sq)}, "after": {leaf: copy}}"""
        n = len(self.names)
        m = self.dst[n:]
        return {**self.info,
                "before": dict(zip(self.names, self.dst[:n])),
                "moments": {name: (m[2 * k], m[2 * k + 1])
                            for k, name in enumerate(self.names)},
                "after": dict(zip(self.names, self.dst_after))}


def first_moments(gen_state, disc_state) -> dict:
    """Each leaf's gradient as the first update got it, from Adam's first
    moment after one step: m1 = (1 - beta1) g."""
    out = {}
    for tag, s in (("gen", gen_state), ("disc", disc_state)):
        beta1 = s.opt.adam.param_groups[0]["betas"][0]
        by_param = {id(p): n for n, p in s.model.named_parameters()}
        for p in s.opt.params:
            state = s.opt.adam.state.get(p, {})
            if "exp_avg" in state:
                out[f"{tag}.{by_param[id(p)]}"] = (state["exp_avg"].clone()
                                                   / (1.0 - beta1))
    return out


def window_counts(batches: Batches, first: int, steps: int,
                  sz: dict) -> dict:
    """The window's operations and MAS bytes, from each step's items at
    their own lengths (counts/train.py, counts/mas.py): what the steps
    need, one generator forward and one alignment of each item a step."""
    from ..counts import mas, train
    items = [batches.items(first + k) for k in range(steps)]
    t = batches.t
    return {"flops": train.step_flops(sz, [x for it in items for x in it]),
            "mas_bytes": sum(mas.bytes_needed(
                it, t["pad_frames"], t["pad_phones"]) for it in items)}


def reference_config(cell, tiny: bool):
    from ..reference import train_step as ref
    t = common.sizes(cell.config, tiny)["train"]
    return ref.TrainConfig(**{f.name: (tuple(t[f.name]) if isinstance(
        t[f.name], list) else t[f.name]) for f in dataclasses.fields(
        ref.TrainConfig)})


def batch_on(batches: Batches, step: int, device, half: bool) -> dict:
    """Step ``step``'s batch on ``device``; ``half`` keeps its first half
    (the planted fault)."""
    batch = {n: torch.from_numpy(v).to(device)
             for n, v in batches.make(step).items()}
    if half:
        keep = batch["phones"].shape[0] // 2
        batch = {n: v[:keep] for n, v in batch.items()}
    return batch


def reference_steps(cell, seed: int, device, tiny: bool,
                    batches: Batches, states: list, half: bool = False
                    ) -> dict:
    """The first steps on the plain reference, at the current precision,
    from the seed's weights, batches and generator states: each step's
    loss terms and generator outputs, the first update's gradients and
    the leaves before and after. ``half`` plants a fault: half of each
    batch left out, the mean taken over the rest."""
    from ..reference import train_step as ref
    scfg, gen, disc = reference_models(cell, seed, device, tiny)
    tc = reference_config(cell, tiny)
    g_opt = ref.Adam(gen.parameters(), tc)
    d_opt = ref.Adam(disc.parameters(), tc)
    names = [f"gen.{n}" for n, _ in gen.named_parameters()] + \
        [f"disc.{n}" for n, _ in disc.named_parameters()]

    def leaves():
        return {n: p.detach().clone() for n, p in zip(
            names, [*gen.parameters(), *disc.parameters()])}

    out = {"before": leaves(), "metrics": [], "forwards": []}
    g = torch.Generator(device)
    for k, state in enumerate(states):
        g.set_state(state)
        batch = batch_on(batches, k, device, half)
        got = ref.train_step(gen, disc, g_opt, d_opt, batch, scfg, tc, g)
        out["metrics"].append({n: float(v)
                               for n, v in got["metrics"].items()})
        out["forwards"].append({"audio": got["audio"],
                                "duration_targets": got["duration_targets"]})
        if k == 0:
            out["grads"] = dict(zip(names, [*g_opt.last_grads,
                                            *d_opt.last_grads]))
    out["after"] = leaves()
    return out


def reference_probe(cell, seed: int, device, tiny: bool, batches: Batches,
                    probe: dict, half: bool = False) -> dict:
    """The window's sampled step on the plain reference, at the current
    precision, from the program's state before it (``Probe``),
    with its batch and generator state: its loss terms, its gradients as
    the update got them, and the leaves after it."""
    from ..reference import train_step as ref
    scfg, gen, disc = reference_models(cell, seed, device, tiny)
    tc = reference_config(cell, tiny)
    opts, names = {}, []
    with torch.no_grad():
        for tag, model in (("gen", gen), ("disc", disc)):
            mine = [f"{tag}.{n}" for n, _ in model.named_parameters()]
            for n, p in zip(mine, model.parameters()):
                p.copy_(probe["before"][n])
            opt = ref.Adam(model.parameters(), tc)
            opt.count = probe["counts"][tag]
            for n, m, v in zip(mine, opt.m, opt.v):
                m.copy_(probe["moments"][n][0])
                v.copy_(probe["moments"][n][1])
            opts[tag] = opt
            names += mine
    g = torch.Generator(device)
    g.set_state(probe["state"])
    got = ref.train_step(gen, disc, opts["gen"], opts["disc"],
                         batch_on(batches, probe["step"], device, half),
                         scfg, tc, g)
    params = [*gen.parameters(), *disc.parameters()]
    return {"metrics": {n: float(v) for n, v in got["metrics"].items()},
            "grads": dict(zip(names, [*opts["gen"].last_grads,
                                      *opts["disc"].last_grads])),
            "after": {n: p.detach().clone() for n, p in zip(names, params)}}


def compare_probe(before: dict, obs: dict, ref: dict) -> dict:
    """The window's sampled step, taken from the same state ``before``:
    its worst loss term (relative) and its change of each leaf against
    the reference's (``change_gaps``)."""
    loss = max(abs(obs["metrics"][n] - v) / max(abs(v), 1e-12)
               for n, v in ref["metrics"].items())
    worst, median = change_gaps(ref["grads"], before, ref["after"], before,
                                obs["after"], "window step")
    return {"win_loss_rel": loss, "win_change_rel": worst,
            "win_change_median_rel": median}


def observed_program(seen: dict, forwards: list) -> dict:
    return {"before": seen["before"], "after": seen["after"],
            "metrics": seen["metrics"], "forwards": forwards,
            "grads": seen["moment"]}


def compare(obs: dict, ref: dict) -> dict:
    """Every number of ``obs`` (the program's first steps, or a control's)
    against the reference's: the worst loss term of the first step
    (relative), the generator's output audio and its MAS durations at the
    first step (share of phones whose frames differ), the worst leaf's
    first gradient and change over the first steps. The later steps'
    loss terms and MAS durations go to standard error: a near tie in the
    alignment of a later step moves them (see PERF.md)."""
    if len(obs["forwards"]) < len(ref["metrics"]):
        return {"audio_rel": math.inf}
    steps = []
    for mine, theirs, fo, fr in zip(obs["metrics"], ref["metrics"],
                                    obs["forwards"], ref["forwards"]):
        a, b = fo["duration_targets"], fr["duration_targets"]
        steps.append({
            "loss_rel": max(abs(mine[n] - v) / max(abs(v), 1e-12)
                            for n, v in theirs.items()),
            "audio_rel": common.rel_gap(fo["audio"], fr["audio"]),
            "mas_share": (float((a != b).float().mean())
                          if a.shape == b.shape else 1.0)})
    print("per step: " + json.dumps(steps), file=sys.stderr)
    out = dict(steps[0])
    out.update(leaf_gaps(ref["grads"], obs["grads"], ref["before"],
                         ref["after"], obs["before"], obs["after"]))
    return out


def check(cell, seed: int, device, tiny: bool, batches: Batches, seen: dict,
          forwards: list, controls: bool = False) -> tuple:
    """(the program's numbers, the controls' numbers or None): the
    controls are the reference in TF32 in the program's place, and the
    reference with half of each batch left out."""
    probe = seen["probe"]
    before = probe["before"]

    def readings(tf32: bool = False, half: bool = False) -> tuple:
        if tf32:
            common.tf32_on()
        try:
            return (reference_steps(cell, seed, device, tiny, batches,
                                    seen["states"], half),
                    reference_probe(cell, seed, device, tiny, batches,
                                    probe, half))
        finally:
            common.float32_only()

    ref, ref_probe = readings()
    mine = {"metrics": {n: float(v) for n, v in probe["metrics"].items()},
            "after": probe["after"]}
    values = {**compare(observed_program(seen, forwards), ref),
              **compare_probe(before, mine, ref_probe)}
    if not controls:
        return values, None
    out = {}
    for name, kw in (("tf32", {"tf32": True}), ("half_batch", {"half": True})):
        steps, at_probe = readings(**kw)
        out[name] = {**compare(steps, ref),
                     **compare_probe(before, at_probe, ref_probe)}
    return values, out


def leaf_gaps(ref_grads: dict, port_grads: dict, ref_before: dict,
              ref_after: dict, port_before: dict, port_after: dict) -> dict:
    """Worst leaf of (a) the first gradient's norm and (b) the norm of the
    change over the first steps: |program's norm - reference's norm| over
    the larger of the reference leaf's norm and the median leaf's. Leaves
    whose reference gradient is under a thousandth of the median leaf's
    move by round-off alone under Adam and are left out of (b)."""
    g_ref = {n: float(x.double().norm()) for n, x in ref_grads.items()}
    med_g = float(np.median(list(g_ref.values())))
    grad, worst = 0.0, None
    for n, r in g_ref.items():
        p = port_grads.get(n)
        pn = float(p.double().norm()) if p is not None else 0.0
        gap = abs(pn - r) / max(r, med_g)
        if gap > grad:
            grad, worst = gap, (n, r / med_g)
    print(f"worst leaf of the first gradient (name, its gradient over the "
          f"median leaf's): {worst}", file=sys.stderr)
    change, median = change_gaps(ref_grads, ref_before, ref_after,
                                 port_before, port_after, "first steps")
    return {"grad_rel": grad, "change_rel": change,
            "change_median_rel": median}


def change_gaps(ref_grads: dict, ref_before: dict, ref_after: dict,
                port_before: dict, port_after: dict, what: str) -> tuple:
    """(worst leaf, median leaf) of |program's norm of a leaf's change -
    reference's| over the larger of the reference leaf's and the median
    leaf's. Leaves whose reference gradient is under a thousandth of the
    median leaf's move by round-off alone under Adam and are left out."""
    g_ref = {n: float(x.double().norm()) for n, x in ref_grads.items()}
    med_g = float(np.median(list(g_ref.values())))
    moved = [n for n in g_ref if g_ref[n] >= 1e-3 * med_g]
    d_ref = {n: float((ref_after[n] - ref_before[n]).double().norm())
             for n in moved}
    med_d = float(np.median(list(d_ref.values())))
    change, gaps, worst = 0.0, [], None
    for n in moved:
        d = float((port_after[n] - port_before[n]).double().norm())
        gap = abs(d - d_ref[n]) / max(d_ref[n], med_d)
        gaps.append(gap)
        if gap > change:
            change, worst = gap, (n, g_ref[n] / med_g)
    median = float(np.median(gaps)) if gaps else 0.0
    print(f"{what}: worst leaf's change {change:.3g} at {worst} (name, "
          f"its gradient over the median leaf's); median leaf's "
          f"{median:.3g}; {len(g_ref) - len(moved)} of {len(g_ref)} leaves "
          f"left out", file=sys.stderr)
    return change, median
