"""Import the reference's PyTorch VISinger checkpoints (``G_AE*.pth``).

The port's counterpart of music_generation_tpu/compat/torch_import.py. A
``SynthesizerTrn`` state_dict (VISinger/models_ae.py) is mapped onto the
JAX package's parameter names, then through
compat.from_jax.visinger_state_dict_from_flax onto the port's VISinger,
so both packages read a reference file the same way. Layouts, on the way
to the flax names:
  - Conv1d   [out, in, k]  -> [k, in, out]
  - ConvT1d  [in, out, k]  -> [k, in, out], flipped along k
  - Linear   [out, in]     -> [in, out]
  - weight norm: the torch (weight_g, weight_v) pair is collapsed to the
    effective weight and stored as (kernel = w_eff, g = ||w_eff|| per
    output channel), the pair flax and the port hold, which reproduces
    w_eff exactly.
Reference keys the mapping does not reach are logged; parameters the file
lacks are left out of the result, so compat.checkpoints.load_params keeps
them at their init (the reference's tolerant load_checkpoint,
VISinger/utils/utils.py:33-58). The AE file (``models_ae.py``, with
spec_decoder) imports into an ``autoencoder`` config and the plain
``models.py`` file (without it) into ``autoencoder=False``; the other pair
is refused, naming the flag, and so is an ``nsf`` config: the reference
has no excitation convs.
"""

from __future__ import annotations

import logging

import numpy as np

from ..models.svs.visinger import SVSConfig
from .from_jax import visinger_state_dict_from_flax

logger = logging.getLogger("music_generation_tpu_torch")


def _conv(w):          # [out, in, k] -> [k, in, out]
    return np.ascontiguousarray(np.transpose(w, (2, 1, 0)))


def _convT(w):         # [in, out, k] -> [k, in, out], flipped in k
    return np.ascontiguousarray(np.transpose(w, (2, 0, 1))[::-1])


def _linear(w):        # [out, in] -> [in, out]
    return np.ascontiguousarray(np.transpose(w))


def _ident(w):
    return np.asarray(w)


def _effective_weight(sd, prefix):
    """Collapse torch weight norm (weight_g, weight_v) to the effective
    weight (torch's norm over every axis but 0); falls back to plain
    ``weight``."""
    if f"{prefix}.weight_v" in sd:
        v = np.asarray(sd[f"{prefix}.weight_v"], np.float32)
        g = np.asarray(sd[f"{prefix}.weight_g"], np.float32)
        axes = tuple(range(1, v.ndim))
        norm = np.sqrt((v ** 2).sum(axis=axes, keepdims=True))
        return g * v / np.maximum(norm, 1e-12)
    return np.asarray(sd[f"{prefix}.weight"], np.float32)


def _set(params, path, value):
    node = params
    for k in path[:-1]:
        node = node.setdefault(k, {})
    node[path[-1]] = value


class _Mapper:
    """Reference keys -> a nested dict under the flax names."""

    def __init__(self, state_dict):
        self.sd = {k: np.asarray(v.detach().cpu().numpy()
                                 if hasattr(v, "detach") else v, np.float32)
                   for k, v in state_dict.items()}
        self.params: dict = {}
        self.used: set = set()

    def copy(self, torch_key, flax_path, transform=_ident):
        if torch_key not in self.sd:
            logger.warning("missing reference key: %s", torch_key)
            return
        _set(self.params, flax_path, transform(self.sd[torch_key]))
        self.used.add(torch_key)

    def conv(self, tprefix, fpath, bias=True, weight_norm=False):
        """Any 1-D conv (plain or weight-normed)."""
        if weight_norm or f"{tprefix}.weight_v" in self.sd:
            if not self._has_weight(tprefix):
                return
            w = _conv(_effective_weight(self.sd, tprefix))
            _set(self.params, fpath + ("kernel",), w)
            _set(self.params, fpath + ("g",),
                 np.linalg.norm(w.reshape(-1, w.shape[-1]), axis=0))
            self.used.update({f"{tprefix}.weight_v", f"{tprefix}.weight_g",
                              f"{tprefix}.weight"} & set(self.sd))
        else:
            self.copy(f"{tprefix}.weight", fpath + ("kernel",), _conv)
        if bias and f"{tprefix}.bias" in self.sd:
            self.copy(f"{tprefix}.bias", fpath + ("bias",))

    def _has_weight(self, tprefix) -> bool:
        if {f"{tprefix}.weight_v", f"{tprefix}.weight"} & set(self.sd):
            return True
        logger.warning("missing reference key: %s.weight_v", tprefix)
        return False

    def convT(self, tprefix, fpath):
        if not self._has_weight(tprefix):
            return
        w = _convT(_effective_weight(self.sd, tprefix))
        _set(self.params, fpath + ("kernel",), w)
        _set(self.params, fpath + ("g",),
             np.linalg.norm(w.reshape(-1, w.shape[-1]), axis=0))
        self.used.update({f"{tprefix}.weight_v", f"{tprefix}.weight_g",
                          f"{tprefix}.weight"} & set(self.sd))
        if f"{tprefix}.bias" in self.sd:
            self.copy(f"{tprefix}.bias", fpath + ("bias",))

    def norm(self, tprefix, fpath):
        self.copy(f"{tprefix}.gamma", fpath + ("LayerNorm_0", "scale"))
        self.copy(f"{tprefix}.beta", fpath + ("LayerNorm_0", "bias"))

    def embed(self, tkey, fpath):
        self.copy(tkey, fpath + ("embedding",))

    def encoder_stack(self, tprefix, fpath, n_layers):
        """attentions.Encoder -> core.attention.TransformerEncoder."""
        for i in range(n_layers):
            a = fpath + (f"attn_{i}",)
            t = f"{tprefix}.attn_layers.{i}"
            for name in ("q", "k", "v"):
                self.conv(f"{t}.conv_{name}", a + (name,))
            self.conv(f"{t}.conv_o", a + ("out",))
            self.copy(f"{t}.emb_rel_k", a + ("emb_rel_k",))
            self.copy(f"{t}.emb_rel_v", a + ("emb_rel_v",))
            self.norm(f"{tprefix}.norm_layers_1.{i}", fpath + (f"norm1_{i}",))
            self.norm(f"{tprefix}.norm_layers_2.{i}", fpath + (f"norm2_{i}",))
            f = fpath + (f"ffn_{i}",)
            self.conv(f"{tprefix}.ffn_layers.{i}.conv_1", f + ("Conv1d_0",))
            self.conv(f"{tprefix}.ffn_layers.{i}.conv_2", f + ("Conv1d_1",))

    def wavenet(self, tprefix, fpath, n_layers):
        for i in range(n_layers):
            self.conv(f"{tprefix}.in_layers.{i}", fpath + (f"in_{i}",),
                      weight_norm=True)
            self.conv(f"{tprefix}.res_skip_layers.{i}",
                      fpath + (f"res_skip_{i}",), weight_norm=True)


def _flax_tree(m: _Mapper, cfg: SVSConfig) -> dict:
    """The key table of the JAX package's visinger_params_from_torch."""
    te = ("text_encoder",)
    m.embed("text_encoder.emb_phoneme.weight", te + ("emb_phoneme",))
    m.embed("text_encoder.emb_note_pitch.weight", te + ("emb_note_pitch",))
    m.embed("text_encoder.emb_phone_shengdiao.weight", te + ("emb_shengdiao",))
    m.copy("text_encoder.emb_note_duration.weight",
           te + ("emb_note_duration", "kernel"), _linear)
    m.copy("text_encoder.emb_note_duration.bias",
           te + ("emb_note_duration", "bias"))
    m.encoder_stack("text_encoder.encoder", te + ("encoder",), cfg.n_layers)

    dp = ("duration_predictor",)
    for i in range(3):
        m.conv(f"duration_predictor.conv_{i + 1}", dp + (f"conv_{i}",))
        m.norm(f"duration_predictor.norm_{i + 1}", dp + (f"norm_{i}",))
    m.conv("duration_predictor.proj", dp + ("proj",))

    tp = ("text_post_net",)
    m.embed("text_post_net.position_embeddings.weight",
            tp + ("position_embeddings",))
    m.embed("text_post_net.f0_emb.weight", tp + ("f0_emb",))
    m.encoder_stack("text_post_net.f0_predictor.encoder",
                    tp + ("f0_predictor", "encoder"), 6)
    m.conv("text_post_net.f0_predictor.output_layer",
           tp + ("f0_predictor", "out"))
    m.conv("text_post_net.mel_predict_net.condition_proj",
           tp + ("mel_predict_net", "condition_proj"))
    m.encoder_stack("text_post_net.mel_predict_net.encoder",
                    tp + ("mel_predict_net", "encoder"), 4)
    m.conv("text_post_net.mel_predict_net.output_layer",
           tp + ("mel_predict_net", "out"))
    m.conv("text_post_net.frame_prior_net.condition_proj",
           tp + ("frame_prior_net", "condition_proj"))
    for i in range(4):
        m.conv(f"text_post_net.frame_prior_net.conv_layers.{i}",
               tp + ("frame_prior_net", f"conv_{i}"))
    m.conv("text_post_net.proj", tp + ("proj",))

    m.conv("spec_encoder.pre", ("spec_encoder", "pre"))
    m.wavenet("spec_encoder.enc", ("spec_encoder", "enc"), 16)
    m.conv("spec_encoder.proj", ("spec_encoder", "proj"))

    for i in range(4):
        t = f"spec_flow.spec_flows.{2 * i}"
        f = ("spec_flow", f"coupling_{i}")
        m.conv(f"{t}.pre", f + ("pre",))
        m.wavenet(f"{t}.enc", f + ("enc",), 4)
        m.conv(f"{t}.post", f + ("post",))

    if cfg.autoencoder:
        m.conv("spec_decoder.pre", ("spec_decoder", "pre"))
        m.wavenet("spec_decoder.enc", ("spec_decoder", "enc"), 16)
        m.conv("spec_decoder.proj", ("spec_decoder", "proj"))
        m.conv("spec_proj", ("spec_proj",))

    dec = ("decoder",)
    m.conv("decoder.conv_pre", dec + ("conv_pre",))
    n_k = len(cfg.resblock_kernel_sizes)
    for i in range(len(cfg.upsample_rates)):
        m.convT(f"decoder.ups.{i}", dec + (f"up_{i}",))
        for j in range(n_k):
            t = f"decoder.resblocks.{i * n_k + j}"
            f = dec + (f"res_{i}_{j}",)
            # one conv (pair) per dilation: the reference's 3 (ResBlock1)
            # or 2 (ResBlock2), which the JAX table writes as constants
            for mm in range(len(cfg.resblock_dilation_sizes[j])):
                if cfg.resblock == "1":
                    m.conv(f"{t}.convs1.{mm}", f + (f"conv1_{mm}",),
                           weight_norm=True)
                    m.conv(f"{t}.convs2.{mm}", f + (f"conv2_{mm}",),
                           weight_norm=True)
                else:
                    m.conv(f"{t}.convs.{mm}", f + (f"conv_{mm}",),
                           weight_norm=True)
    m.conv("decoder.conv_post", dec + ("conv_post",), bias=False)
    return m.params


def visinger_state_dict_from_torch(state_dict, cfg: SVSConfig) -> dict:
    """The port's VISinger(cfg) state_dict from a reference
    ``SynthesizerTrn`` state_dict (models_ae.py for an ``autoencoder``
    config, models.py for ``autoencoder=False``), or from the reference
    trainer's ``{"model": state_dict, "iteration": ...}`` wrapper
    (VISinger/utils/utils.py:61-72)."""
    if isinstance(state_dict.get("model"), dict):
        state_dict = state_dict["model"]
    if cfg.decoder_type != "hifigan":
        raise ValueError("reference checkpoints carry the HiFi-GAN decoder; "
                         f"got decoder_type={cfg.decoder_type!r}")
    if cfg.nsf:
        raise ValueError("reference checkpoints have no NSF excitation "
                         "convs (decoder.exc.*): import them into a config "
                         "without nsf")
    has_ae = any(k.startswith("spec_decoder.") for k in state_dict)
    if has_ae != cfg.autoencoder:
        raise ValueError(
            "the checkpoint is the reference's "
            + ("AE models_ae.py variant (it has spec_decoder): import it "
               "with autoencoder=True (no --no-autoencoder)" if has_ae else
               "non-AE models.py variant (it has no spec_decoder): import "
               "it with autoencoder=False (--no-autoencoder)"))
    m = _Mapper(state_dict)
    tree = _flax_tree(m, cfg)
    unused = sorted(set(m.sd) - m.used)
    if unused:
        logger.info("unused reference keys (%d): %s", len(unused),
                    unused[:8])
    return visinger_state_dict_from_flax(tree, cfg, strict=False)
