"""The port's device mesh (parallel/mesh.py) and the meshed batched SVS
call, on CPU "devices".

The tensor-parallel rule against the JAX package's param_partition_spec on
a list of shapes; make_mesh's grid and its refusal; SVSSynthesizer with
mesh (2, 1), (2, 2) and (4, 1) against the unmeshed synthesizer on the
same weights, within the bounds of tests/test_mesh_inference.py (at most
64 int16 LSB, mean error under 1e-3 of the peak); one sentence padded to
the data axis; serve.app's --mesh 1x1 song equal to the song without it.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from music_generation_tpu.parallel import mesh as j_mesh
from music_generation_tpu_torch.parallel import (make_mesh, mesh_shape,
                                                 param_partition_spec)
from music_generation_tpu_torch.pipeline.synthesis import (SVSSynthesizer,
                                                           tiny_configs)

# the JAX test's tiny SVS config, with a 128-channel first upsample so that
# its [128, 64, 8] transposed-conv weight reaches the 2**16 threshold and
# the (2, 2) mesh splits it
CFG = dataclasses.replace(tiny_configs(0)[1], upsample_rates=(4, 4),
                          upsample_kernel_sizes=(8, 8), hop_length=16,
                          upsample_initial_channel=128)
SHAPES = [(64, 1024), (256, 256), (255, 257), (4, 128, 128), (3,),
          (2 ** 16,), (8, 8192), (16, 4096, 3), (300, 300), (1024, 64)]


@pytest.mark.parametrize("n_model", [1, 2, 4, 3])
def test_partition_rule_matches_jax(n_model):
    for shape in SHAPES:
        want = j_mesh.param_partition_spec((), jnp.zeros(shape), n_model)
        got = param_partition_spec("w", torch.zeros(shape), n_model)
        assert got == tuple(want), (shape, got, want)


@pytest.mark.parametrize("min_size", [256, 2 ** 16])
def test_model_shardings_match_jax(min_size):
    """param_shardings of the port's VISinger and MultiPeriodDiscriminator
    split exactly the weights the JAX rule splits in their flax trees
    (each port parameter as its JAX twin lays it out), at the default
    threshold and at one that splits most of the tiny model."""
    from music_generation_tpu.models.svs import hifigan as jh
    from music_generation_tpu.models.svs import visinger as jv
    from music_generation_tpu.train import configs as j_configs
    from music_generation_tpu.train import data as j_data
    from music_generation_tpu_torch.compat.from_jax import _port_name
    from music_generation_tpu_torch.models.svs import (
        MultiPeriodDiscriminator, VISinger)
    from music_generation_tpu_torch.parallel import param_shardings
    from music_generation_tpu_torch.train import build_svs_config
    import jax
    jcfg = j_configs.build_svs_config(tiny=True)
    b = j_data.synthetic_batch(jcfg, batch=1, t_phones=8, t_frames=32)
    keys = ("phones", "x_lengths", "spec", "y_lengths", "note_ids",
            "note_durations", "f0_score", "phone_durations", "shengdiao")
    seg = np.zeros((1, jcfg.segment_size, 1), np.float32)
    rngs = {k: jax.random.PRNGKey(0)
            for k in ("params", "noise", "slice", "dropout")}
    pairs = (
        (jax.eval_shape(lambda: jv.VISinger(jcfg).init(
            rngs, *[b[k] for k in keys], deterministic=True)),
         VISinger(build_svs_config(tiny=True))),
        (jax.eval_shape(lambda: jh.MultiPeriodDiscriminator().init(
            rngs, seg, seg)), MultiPeriodDiscriminator()))
    for tree, model in pairs:
        want = {}
        for path, leaf in jax.tree_util.tree_flatten_with_path(
                tree["params"])[0]:
            names = tuple(str(getattr(k, "key", k)) for k in path)
            want[_port_name(names)] = bool(j_mesh.param_partition_spec(
                names, jnp.zeros(leaf.shape), 2, min_size))
        got = {n: a is not None
               for n, a in param_shardings(model, 2, min_size).items()}
        assert got == want
        assert any(got.values())


def test_make_mesh_grid_and_refusal():
    cpu = [torch.device("cpu")] * 4
    grid = make_mesh(2, 2, cpu)
    assert mesh_shape(grid) == {"data": 2, "model": 2}
    assert make_mesh(n_model=2, devices=cpu) == grid
    assert mesh_shape(make_mesh(4, 1, cpu)) == {"data": 4, "model": 1}
    with pytest.raises(ValueError, match="needs 6 devices; 4 available"):
        make_mesh(3, 2, cpu)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="needs 2 devices; 0 available"):
            make_mesh(2, 1)


def _scores(svs, n):
    texts = ["你好世界", "小小的天", "隐形的翅膀", "带我飞翔"]
    out = []
    for i in range(n):
        text = texts[i % len(texts)]
        notes = ["C4", "C4", "D4", "D4", "E4", "E4", "F4",
                 "F4"][: 2 * len(text)]
        out.append(svs.frontend.align(text, notes, [0.3] * len(notes)))
    return out


@pytest.mark.parametrize("n_data,n_model", [(2, 1), (2, 2), (4, 1)])
def test_meshed_batch_matches_single_device(n_data, n_model):
    base = SVSSynthesizer(CFG, seed=3, device="cpu")
    scores = _scores(base, 5)  # pads to 6 or 8 rows on the data axis
    ref = base.synthesize_batch(scores)
    meshed = SVSSynthesizer(CFG, seed=3, device="cpu")
    meshed.place_on_mesh(make_mesh(n_data, n_model,
                                   ["cpu"] * (n_data * n_model)))
    assert all(bool(r.shards) == (n_model > 1) for r in meshed._rows)
    got = meshed.synthesize_batch(scores)
    assert len(got) == len(ref) == 5
    for a, b in zip(ref, got):
        assert a.shape == b.shape and a.dtype == b.dtype == np.int16
        assert np.abs(a.astype(np.int32) - b.astype(np.int32)).max() <= 64
        denom = max(float(np.abs(a).max()), 1.0)
        assert np.mean(np.abs(a - b)) / denom < 1e-3
    # the next call draws on from the same generator state on both
    assert torch.equal(base.generator.get_state(),
                       meshed.generator.get_state())


def test_meshed_batch_pads_to_data_axis():
    svs = SVSSynthesizer(CFG, seed=0, device="cpu",
                         mesh=make_mesh(4, 1, ["cpu"] * 4))
    wavs = svs.synthesize_batch(_scores(svs, 1))
    assert len(wavs) == 1 and wavs[0].dtype == np.int16 and len(wavs[0])


def test_server_mesh_1x1_song_equals_unmeshed():
    """serve.app's songs with --mesh 1x1 (--device cpu) sing the same WAV
    bytes as without it."""
    from music_generation_tpu_torch.serve import app
    wavs = []
    for extra in ([], ["--mesh", "1x1"]):
        args, cfg = app.configure(["--tiny", "--device", "cpu"] + extra)
        songs = app.build_songs(args, cfg)
        # one batched path: without --mesh the mesh is the device alone
        assert all(svs.mesh == [[torch.device("cpu")]]
                   and svs._rows[0].model is svs.model
                   for svs in songs.synthesizers.values())
        wavs.append(songs.synthesize_song("你好世界。小小的天")
                    .wav_bytes)
    assert wavs[0] == wavs[1]
