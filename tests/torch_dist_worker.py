"""One rank of tests/test_torch_multihost.py's gloo group (CPU).

    python tests/torch_dist_worker.py RANK WORLD PORT OUT_DIR

Each rank holds rows [2 * rank, 2 * rank + 2) of a ragged 4-row batch
(WORLD = 2) and runs, in one process group:
  - dp: one training step on a (2, 1) mesh with --durations mas, in
    float32 and in float64;
  - tp: one training step on a (1, 2) mesh in float64, the weights of at
    least TP_MIN_SIZE elements sharded over the model group;
  - losses: the globally normalised loss terms on ragged masks, each
    rank's share summed over the group.
Rank 0 also takes the one-process step on the whole batch from the same
weights and generator seed, and compares: the relative error of every
metric, of every updated tensor (gathered from the shards; against the
larger of its magnitude and the learning rate, the most one update moves
an element) and of the Adam moments (against the module's largest).
Parameters are compared in float64: Adam divides each gradient by its own
magnitude (eps 1e-9), so in float32 a gradient that is zero up to
rounding (the attention key biases, whose gradient the softmax cancels)
moves its weight by up to the learning rate either way.
Each rank writes OUT_DIR/rank<RANK>.json.
"""

import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))
sys.modules["torch.utils.tensorboard"] = None  # noqa: E402 (TF import cost)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from music_generation_tpu_torch.parallel import (StepMesh,  # noqa: E402
                                                 make_hybrid_mesh)
from music_generation_tpu_torch.train import (TrainConfig,  # noqa: E402
                                              build_svs_config,
                                              create_states, losses,
                                              make_train_step,
                                              synthetic_batch)
from music_generation_tpu_torch.train.trainer import (  # noqa: E402
    distribute_states, full_state_dicts)

ROWS = 2                   # per rank
TP_MIN_SIZE = 256          # splits most of the tiny generator's weights
X_LENGTHS = [8, 5, 7, 6]
Y_LENGTHS = [32, 20, 27, 24]


def global_batch(dtype) -> dict:
    cfg = build_svs_config(tiny=True)
    b = synthetic_batch(cfg, batch=4, t_phones=8, t_frames=32, seed=3)
    b["x_lengths"] = np.asarray(X_LENGTHS, np.int32)
    b["y_lengths"] = np.asarray(Y_LENGTHS, np.int32)
    return {k: torch.as_tensor(np.asarray(v)).to(
        dtype if np.asarray(v).dtype == np.float32 else None)
        for k, v in b.items()}


def rel(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0) -> float:
    """max |got - want| over max(max |want|, floor) (the difference itself
    when that is 0)."""
    got, want = got.double(), want.double()
    scale = max(float(want.abs().max()), floor)
    diff = float((got - want).abs().max())
    return diff / scale if scale else diff


def step_case(rank: int, n_model: int, use_mas: bool,
              dtype=torch.float32) -> dict:
    torch.set_default_dtype(dtype)
    cfg = build_svs_config(tiny=True)
    tcfg = TrainConfig(use_mas=use_mas)
    batch = global_batch(dtype)
    local = {k: v[rank * ROWS: (rank + 1) * ROWS] for k, v in batch.items()}
    mesh = StepMesh.from_mesh(make_hybrid_mesh(n_model, "cpu"))
    gen_state, disc_state = create_states(cfg, tcfg, "cpu")
    distribute_states(gen_state, disc_state, mesh, min_size=TP_MIN_SIZE)
    metrics = make_train_step(cfg, tcfg, mesh)(
        gen_state, disc_state, local,
        torch.Generator().manual_seed(tcfg.seed))
    row = {"metrics": {k: float(v) for k, v in metrics.items()},
           "sharded": sum(len(s.shards.shards) for s in
                          (gen_state, disc_state) if s.shards is not None)}
    full = [full_state_dicts(s) for s in (gen_state, disc_state)]
    if rank:
        return row
    ref_gen, ref_disc = create_states(cfg, tcfg, "cpu")
    ref = make_train_step(cfg, tcfg)(ref_gen, ref_disc, batch,
                                     torch.Generator().manual_seed(tcfg.seed))
    row["metric_rel"] = {k: rel(metrics[k], v) for k, v in ref.items()}
    params, moments = {}, {}
    for (model_sd, opt_sd), state, tag in zip(full, (ref_gen, ref_disc),
                                              ("gen", "disc")):
        for name, want in state.model.state_dict().items():
            params[f"{tag}.{name}"] = rel(model_sd[name], want,
                                          tcfg.learning_rate)
        ref_opt = state.opt.state_dict()["adam"]["state"]
        for k in ("exp_avg", "exp_avg_sq"):
            top = max(float(st[k].abs().max()) for st in ref_opt.values())
            for i, st in opt_sd["adam"]["state"].items():
                moments[f"{tag}.{i}.{k}"] = rel(st[k], ref_opt[i][k], top)
    for key, worst in (("param", params), ("moment", moments)):
        row[f"{key}_rel_max"] = max(worst.values())
        row[f"{key}_rel_worst"] = max(worst, key=worst.get)
    torch.set_default_dtype(torch.float32)
    return row


def losses_case(rank: int) -> dict:
    """Each loss term's share on this rank's rows of a ragged global batch
    (numpy-seeded), summed over the group."""
    mesh = StepMesh.from_mesh(make_hybrid_mesh(1, "cpu"))
    arrays = loss_inputs()
    local = {k: torch.as_tensor(v[rank * ROWS: (rank + 1) * ROWS])
             for k, v in arrays.items()}
    terms = loss_terms(local, mesh)
    return {k: float(mesh.sum(v)) for k, v in terms.items()}


def loss_inputs(seed: int = 5) -> dict:
    """Ragged inputs of the masked terms (4 rows): masks from Y_LENGTHS and
    X_LENGTHS, log-scales in [-1, 1]."""
    rng = np.random.RandomState(seed)
    f, t, c = 32, 8, 6
    y_mask = (np.arange(f)[None, :] < np.asarray(Y_LENGTHS)[:, None])
    x_mask = (np.arange(t)[None, :] < np.asarray(X_LENGTHS)[:, None])
    a = {k: rng.randn(4, f, c).astype(np.float32)
         for k in ("z_p", "m_p", "m_q", "spec_a", "spec_b")}
    a.update({k: rng.uniform(-1, 1, (4, f, c)).astype(np.float32)
              for k in ("logs_q", "logs_p")})
    a["y_mask"] = y_mask[..., None].astype(np.float32)
    a["x_mask"] = x_mask.astype(np.float32)
    a["frac"] = rng.uniform(0, 1, (4, t)).astype(np.float32)
    a["note_dur"] = rng.uniform(0.1, 0.5, (4, t)).astype(np.float32)
    a["ph_dur"] = rng.randint(1, 9, (4, t)).astype(np.int32)
    a["lf0_a"] = rng.randn(4, f).astype(np.float32)
    a["lf0_b"] = rng.randn(4, f).astype(np.float32)
    # louder fakes: a log-RMS ratio near 0 would leave the squared energy
    # term with few significant float32 bits
    a["y_fake"] = rng.randn(4, 4096).astype(np.float32) * 0.5
    a["y_real"] = rng.randn(4, 4096).astype(np.float32) * 0.3
    return a


def loss_terms(a: dict, mesh=None) -> dict:
    """The terms train.losses takes a mesh for, on tensors ``a``; the JAX
    package's functions of the same names take the same arguments."""
    lib = losses
    kw = {} if mesh is None else {"mesh": mesh}
    return {
        "kl": lib.kl_divergence(a["z_p"], a["logs_q"], a["m_p"], a["logs_p"],
                                a["y_mask"], **kw),
        "nll": lib.gaussian_nll(a["z_p"], a["m_q"], a["logs_q"], a["y_mask"],
                                **kw),
        "dur": lib.duration_loss(a["frac"], a["note_dur"], a["ph_dur"],
                                 0.0116, a["x_mask"], **kw),
        "f0": lib.f0_loss(a["lf0_a"], a["lf0_b"], a["y_mask"][..., 0], **kw),
        "l1_masked": lib.l1_masked(a["spec_a"], a["spec_b"], a["y_mask"],
                                   **kw),
        "l1": lib.l1_masked(a["spec_a"], a["spec_b"], **kw),
        "stft": lib.multires_stft_loss(a["y_fake"], a["y_real"], **kw),
        "energy": lib.energy_loss(a["y_fake"], a["y_real"], **kw),
    }


def main(rank: int, world: int, port: int, out: str) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        result = {"dp32": step_case(rank, 1, use_mas=True),
                  "dp": step_case(rank, 1, True, torch.float64),
                  "tp": step_case(rank, 2, False, torch.float64),
                  "losses": losses_case(rank)}
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as fh:
        json.dump(result, fh)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
