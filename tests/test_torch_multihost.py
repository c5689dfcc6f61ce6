"""The port's multi-process training on the CPU (gloo), against one process
and the JAX package's losses.

Two processes of the trainer CLI (--tiny --multihost --coordinator) print
the same finite losses and leave one restorable step_2.pt, as
tests/test_multihost.py asserts of the JAX CLI. Two ranks of
tests/torch_dist_worker.py take one data-parallel (2, 1) and one
tensor-parallel (1, 2) step against the one-process step on the
concatenated ragged batch with the same weights and draws: every loss term
within 1e-6 relative (float32 and float64), every updated tensor and Adam
moment within 1e-6 (float64; see the worker's docstring), both ranks'
metrics identical. The globally normalised loss terms, each rank's share
summed over the group, hold against the JAX package's losses on the
global batch within 1e-6 relative.
"""

import ast
import json
import os
import socket
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.train import losses as jl

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, HERE)
import torch_dist_worker as worker  # noqa: E402

TOL = 1e-6
WORLD = 2


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv_of) -> list:
    """Start one process per rank (``argv_of(rank)``)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=ROOT)
    return [subprocess.Popen(argv_of(r), cwd=ROOT, env=env,
                             stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
            for r in range(WORLD)]


def finish(procs, timeout=240) -> list:
    """Each process's (returncode, output), killing any left over."""
    try:
        return [(p.wait(timeout=timeout), p.stdout.read()) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()


def jax_losses() -> dict:
    """The JAX package's loss functions on the worker's global inputs."""
    j = {k: jnp.asarray(v) for k, v in worker.loss_inputs().items()}
    return {k: float(v) for k, v in {
        "kl": jl.kl_divergence(j["z_p"], j["logs_q"], j["m_p"], j["logs_p"],
                               j["y_mask"]),
        "nll": jl.gaussian_nll(j["z_p"], j["m_q"], j["logs_q"], j["y_mask"]),
        "dur": jl.duration_loss(j["frac"], j["note_dur"], j["ph_dur"], 0.0116,
                                j["x_mask"]),
        "f0": jl.f0_loss(j["lf0_a"], j["lf0_b"], j["y_mask"][..., 0]),
        "l1_masked": jl.l1_masked(j["spec_a"], j["spec_b"], j["y_mask"]),
        "l1": jl.l1_masked(j["spec_a"], j["spec_b"]),
        "stft": jl.multires_stft_loss(j["y_fake"], j["y_real"]),
        "energy": jl.energy_loss(j["y_fake"], j["y_real"]),
    }.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two gloo groups at once, the workers' and the trainer CLI's (2 steps,
    --tiny), with the JAX losses computed meanwhile: (worker results per
    rank, CLI outputs per rank, the CLI's checkpoint dir, JAX losses)."""
    out = tmp_path_factory.mktemp("ranks")
    ck = tmp_path_factory.mktemp("cli") / "ck"
    wport, cport = free_port(), free_port()
    workers = launch(lambda r: [sys.executable,
                                os.path.join(HERE, "torch_dist_worker.py"),
                                str(r), str(WORLD), str(wport), str(out)])
    code = ("import sys; sys.modules['torch.utils.tensorboard'] = None; "
            "from music_generation_tpu_torch.train.__main__ import main; "
            "main(sys.argv[1:])")
    cli = launch(lambda r: [
        sys.executable, "-c", code, "--tiny", "--steps", "2", "--device",
        "cpu", "--multihost", "--coordinator", f"127.0.0.1:{cport}",
        "--nprocs", str(WORLD), "--proc-id", str(r), "--log-every", "1",
        "--prefetch", "0", "--ckpt-dir", str(ck)])
    want = jax_losses()
    cli_done, workers_done = finish(cli), finish(workers)
    for rc, log in workers_done:
        assert rc == 0, log[-3000:]
    ranks = [json.load(open(out / f"rank{r}.json")) for r in range(WORLD)]
    return ranks, cli_done, ck, want


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


def test_cli_two_processes(runs):
    """Both processes print the same finite losses at every logged step;
    process 0 alone writes one step_2.pt that restores, with the global
    batch's metrics."""
    _, done, ck, _ = runs
    steps = []
    for r, (rc, log) in enumerate(done):
        assert rc == 0, log[-3000:]
        assert f"process {r}/{WORLD}" in log
        steps.append([ln.split(": ", 1)[1] for ln in log.splitlines()
                      if ln.startswith("step ")])
    assert "mesh: {'data': 2, 'model': 1} over 2 devices" in done[0][1]
    assert len(steps[0]) == 2 and steps[0] == steps[1]
    for line in steps[0]:
        assert all(np.isfinite(v) for v in ast.literal_eval(line).values())
    assert sorted(os.listdir(ck)) == ["best.json", "logs", "step_2.pt"]
    from music_generation_tpu_torch.train import (TrainConfig,
                                                  build_svs_config,
                                                  create_states,
                                                  restore_checkpoint)
    g, d = create_states(build_svs_config(tiny=True), TrainConfig(), "cpu")
    restore_checkpoint(str(ck / "step_2.pt"), g, d)
    assert g.step == d.step == 2 and g.opt.count == 2
    with open(ck / "logs" / "train_metrics.jsonl") as fh:
        rows = [json.loads(line) for line in fh]
    assert [r["step"] for r in rows] == [0, 1]
    last = ast.literal_eval(steps[0][-1])
    assert round(rows[-1]["loss_gen"], 4) == last["loss_gen"]
    os.remove(ck / "step_2.pt")  # a full discriminator's file, 0.5 GB


@pytest.mark.parametrize("case", ["dp32", "dp", "tp"])
def test_step_matches_one_process(ranks, case):
    """One step on two ranks against the one-process step on the
    concatenated batch: loss terms, updated weights and Adam moments."""
    r0, r1 = ranks[0][case], ranks[1][case]
    assert r0["metrics"] == r1["metrics"]
    assert max(r0["metric_rel"].values()) < TOL, r0["metric_rel"]
    if case != "dp32":  # parameters in float64 (the worker's docstring)
        assert r0["param_rel_max"] < TOL, r0["param_rel_worst"]
        assert r0["moment_rel_max"] < TOL, r0["moment_rel_worst"]
    # the tensor-parallel case holds weights as shards over the model group
    assert (r0["sharded"] > 0) == (case == "tp")


def test_global_losses_match_jax(runs):
    """Each masked and mean term on a ragged batch split over two ranks,
    shares summed, against the JAX package's function on the whole
    batch."""
    ranks, _, _, want = runs
    got = ranks[0]["losses"]
    assert got == ranks[1]["losses"]
    for k, v in want.items():
        assert abs(got[k] - v) <= TOL * abs(v), (k, got[k], v)
    # one device: the same functions without a mesh
    one = worker.loss_terms({k: torch.as_tensor(v) for k, v in
                             worker.loss_inputs().items()})
    for k, v in one.items():
        assert abs(float(v) - got[k]) <= TOL * abs(got[k]), k
