"""JAX trainer step directories into the port (tools/torch_import_pipeline.py
--jax-step and --jax-seq-step), against optax.

A JAX GAN step (tiny VISinger and the full MultiPeriodDiscriminator,
random weights, the optax chain's state with perturbed moments and count,
with and without MultiSteps accumulation) and a train.seq step of
melody_note and duration_mse (random weights, optax adamw state with
perturbed moments), each saved by orbax as the JAX trainers save them, are
converted and restored into the port: every weight, moment and
accumulator equals its source after the layout transform, the counts carry
across, and one optimizer update from the converted state lands within
1e-6 (relative to the largest weight of its tensor) of optax's update on
the same gradient. A state whose layout does not map converts params and
step only, with a fresh optimizer, and says so.
"""

import importlib.util
import os
import shutil

import jax
import numpy as np
import optax
import orbax.checkpoint as ocp
import pytest
import torch

from music_generation_tpu.models.melody import transformer as j_tr
from music_generation_tpu.models.svs import hifigan as jh
from music_generation_tpu.models.svs import visinger as jv
from music_generation_tpu.train import configs as j_configs
from music_generation_tpu.train import data as j_data
from music_generation_tpu.train import seq as j_seq
from music_generation_tpu.train import trainer as j_trainer
from music_generation_tpu_torch.compat import (mpd_state_dict_from_flax,
                                               visinger_state_dict_from_flax)
from music_generation_tpu_torch.train import (TrainConfig, build_svs_config,
                                              create_states,
                                              restore_checkpoint)
from music_generation_tpu_torch.train.seq import build_family
from music_generation_tpu_torch.train.seq_losses import SeqOptimizer
from torch_port_util import _shapes_only_init, init_params, random_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "torch_import_pipeline", os.path.join(ROOT, "tools",
                                          "torch_import_pipeline.py"))
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)

TOL = 1e-6
CFG = build_svs_config(tiny=True)
JCFG = j_configs.build_svs_config(tiny=True)
COUNT = 5


def perturbed(tx, params, seed: int, k: int = 1, cheap: bool = False):
    """``tx``'s state for ``params`` (its shapes from eval_shape), every
    leaf set: Adam's mu ~ N(0, 1e-2), nu ~ U(1e-6, 1e-4) and count COUNT;
    MultiSteps' acc_grads ~ N(0, 1e-2), mini_step k - 1 (the next call
    applies) and gradient_step COUNT. ``cheap``: constant moments (the
    full discriminator's 47M)."""
    rng = np.random.RandomState(seed)

    def leaf(path, x):
        names = {getattr(p, "name", getattr(p, "key", None)) for p in path}
        shape = np.shape(x)
        if "count" in names or "gradient_step" in names:
            return np.asarray(COUNT, x.dtype)
        if "mini_step" in names:
            return np.asarray(k - 1, x.dtype)
        if cheap:
            if "nu" in names:
                return np.full(shape, 1e-5, np.float32)
            if "mu" in names or "acc_grads" in names:
                return np.full(shape, 1e-3, np.float32)
            return x
        if "nu" in names:
            return rng.uniform(1e-6, 1e-4, shape).astype(np.float32)
        if "mu" in names or "acc_grads" in names:
            return (rng.randn(*shape) * 1e-2).astype(np.float32)
        raise AssertionError(f"unexpected optimizer leaf {path}")
    return jax.tree_util.tree_map_with_path(
        leaf, jax.eval_shape(tx.init, params))


def optax_step(tx, grads, opt_state, params):
    """optax's update of ``params`` on ``grads``, on the trees raveled into
    one vector (every transformation of these chains is elementwise but the
    global-norm clip, which is the same norm): one small jitted program
    instead of one per leaf."""
    from jax.flatten_util import ravel_pytree
    flat, unravel = ravel_pytree(params)
    treedef = jax.tree_util.tree_structure(params)

    def is_tree(x):
        return jax.tree_util.tree_structure(x) == treedef

    def ravel(tree):
        return jax.tree_util.tree_map(
            lambda x: ravel_pytree(x)[0] if is_tree(x) else x, tree,
            is_leaf=is_tree)

    def fn(g, s, p):
        return optax.apply_updates(p, tx.update(g, s, p)[0])
    return unravel(jax.jit(fn)(ravel_pytree(grads)[0], ravel(opt_state),
                               flat))


def adam_of(opt_state) -> optax.ScaleByAdamState:
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)  # noqa: E731
    return next(x for x in jax.tree_util.tree_leaves(opt_state,
                                                     is_leaf=is_adam)
                if is_adam(x))


def grads_like(params, seed: int):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda x: (rng.randn(*np.shape(x)) * 1e-2).astype(np.float32), params)


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def assert_same(got: dict, want: dict, tol: float = 0.0):
    assert got.keys() == want.keys()
    for k in want:
        if tol:
            assert rel(got[k], want[k]) <= tol, k
        else:
            assert torch.equal(got[k].cpu(), want[k]), k


def moments(opt, names) -> dict:
    """{name: (exp_avg, exp_avg_sq, step)} of a port optimizer."""
    out = {}
    for name, p in zip(names, opt.params):
        st = opt.adam.state[p] if hasattr(opt, "adam") else opt.adamw.state[p]
        out[name] = (st["exp_avg"], st["exp_avg_sq"], float(st["step"]))
    return out


@pytest.fixture(scope="module")
def gan_params():
    """Random (generator, discriminator) weights, shapes from eval_shape."""
    batch = j_data.synthetic_batch(JCFG, batch=1, t_phones=8, t_frames=32)
    gen_args = [batch[k] for k in ("phones", "x_lengths", "spec",
                                   "y_lengths", "note_ids", "note_durations",
                                   "f0_score", "phone_durations",
                                   "shengdiao")]
    seg = np.zeros((1, JCFG.segment_size, 1), np.float32)
    return (init_params(jv.VISinger(JCFG), 0, *gen_args,
                        deterministic=True)["params"],
            init_params(jh.MultiPeriodDiscriminator(), 1, seg, seg)["params"])


@pytest.mark.parametrize("accumulate", [1, 2])
def test_gan_step_converts(accumulate, gan_params, tmp_path):
    tc = j_trainer.TrainConfig(accumulate_grad_batches=accumulate)
    gp, dp = gan_params
    states, txs = {}, {}
    for key, params, cheap in (("gen", gp, False), ("disc", dp, True)):
        txs[key] = j_trainer.make_optimizer(tc)
        states[key] = j_trainer.TrainState(
            step=COUNT, apply_fn=None, params=params, tx=txs[key],
            opt_state=perturbed(txs[key], params, 7, accumulate, cheap))
    j_trainer.save_checkpoint(str(tmp_path / "jax"), states["gen"],
                              states["disc"], COUNT)
    out = tmp_path / "port"
    tool.main(["--jax-step", str(tmp_path / "jax" / f"step_{COUNT}"),
               "--out", str(out), "--tiny"])
    shutil.rmtree(tmp_path / "jax")
    file = out / f"step_{COUNT}.pt"
    g, d = create_states(CFG, TrainConfig(
        accumulate_grad_batches=accumulate), "cpu")
    restore_checkpoint(str(file), g, d)
    os.remove(file)

    mappers = {"gen": lambda t: visinger_state_dict_from_flax(t, CFG),
               "disc": mpd_state_dict_from_flax}
    for key, port in (("gen", g), ("disc", d)):
        mapper, st = mappers[key], states[key]
        assert port.step == COUNT and port.opt.count == COUNT
        assert port.opt.mini_step == accumulate - 1
        names = [n for n, _ in port.model.named_parameters()]
        assert_same(port.model.state_dict(), mapper(st.params))
        adam = adam_of(st.opt_state)
        mu, nu = mapper(adam.mu), mapper(adam.nu)
        got = moments(port.opt, names)
        for n in names:
            assert torch.equal(got[n][0], mu[n]) and torch.equal(
                got[n][1], nu[n]) and got[n][2] == COUNT, n
        if accumulate > 1:
            acc = mapper(st.opt_state.acc_grads)
            assert all(torch.equal(a, acc[n])
                       for a, n in zip(port.opt.acc, names))
        else:
            assert port.opt.acc is None
        if key == "disc":
            continue  # one update of the 47M-weight discriminator is slow
        # one update on the same gradient: the port against optax
        grads = grads_like(st.params, 11)
        want = mapper(optax_step(txs[key], grads, st.opt_state, st.params))
        mapped = mapper(grads)
        port.opt.update([mapped[n] for n in names])
        assert_same(port.model.state_dict(), want, tol=TOL)


def _seq_state(family: str, tmp_path):
    """A JAX train.seq step of ``family`` saved by orbax as train_family
    saves it: random weights (shapes only from build_family), the optax
    chain's state perturbed."""
    with _shapes_only_init(j_tr.MelodyTransformer), \
            _shapes_only_init(j_tr.MSEDurationModel):
        _, shapes, _, _ = j_seq.build_family(family, True, None)
    params = random_params(shapes, 3)
    tx = optax.chain(optax.clip_by_global_norm(5.0), optax.adamw(3e-4))
    opt_state = perturbed(tx, params, 9)
    path = tmp_path / "jax" / family / f"step_{COUNT}"
    ck = ocp.StandardCheckpointer()
    ck.save(str(path), {"params": params, "opt_state": opt_state,
                        "step": COUNT}, force=True)
    ck.wait_until_finished()
    return params, tx, opt_state, path


@pytest.mark.parametrize("family", ["melody_note", "duration_mse"])
def test_seq_step_converts(family, tmp_path):
    params, tx, opt_state, path = _seq_state(family, tmp_path)
    tool.main(["--jax-seq-step", str(path), "--family", family, "--out",
               str(tmp_path / "port"), "--tiny"])
    file = tmp_path / "port" / family / f"step_{COUNT}.pt"
    saved = torch.load(file, weights_only=True)
    assert saved["step"] == COUNT
    model, _, _ = build_family(family, True, None, device="cpu")
    model.load_state_dict(saved["params"])
    opt = SeqOptimizer(model.parameters(), 3e-4)
    opt.load_state_dict(saved["opt_state"])
    mapper = tool._seq_mapper(family, model)
    names = [n for n, _ in model.named_parameters()]
    assert_same({n: p.detach() for n, p in model.named_parameters()},
                mapper(params))
    adam = adam_of(opt_state)
    mu, nu = mapper(adam.mu), mapper(adam.nu)
    got = moments(opt, names)
    for n in names:
        assert torch.equal(got[n][0], mu[n]) and torch.equal(got[n][1], nu[n])
        assert got[n][2] == COUNT
    grads = grads_like(params, 13)
    want = mapper(optax_step(tx, grads, opt_state, params))
    mapped = mapper(grads)
    opt.update([mapped[n] for n in names])
    assert_same({n: p.detach() for n, p in model.named_parameters()}, want,
                tol=TOL)


def test_unmapped_optimizer_keeps_params_only(tmp_path, capsys):
    """An optimizer state without Adam moments (another optax chain):
    params and step carry across, the optimizer starts fresh, and the
    tool says so on stdout."""
    params, _, _, _ = _seq_state("duration_mse", tmp_path)
    path = tmp_path / "jax" / "sgd" / "step_3"
    ck = ocp.StandardCheckpointer()
    sgd = jax.tree_util.tree_map(lambda x: np.zeros(x.shape, x.dtype),
                                 jax.eval_shape(optax.sgd(
                                     0.1, momentum=0.9).init, params))
    ck.save(str(path), {"params": params, "opt_state": sgd, "step": 3},
            force=True)
    ck.wait_until_finished()
    tool.main(["--jax-seq-step", str(path), "--family", "duration_mse",
               "--out", str(tmp_path / "port"), "--tiny"])
    assert "does not map" in capsys.readouterr().out
    saved = torch.load(tmp_path / "port" / "duration_mse" / "step_3.pt",
                       weights_only=True)
    assert saved["step"] == 3 and saved["opt_state"]["state"] == {}
