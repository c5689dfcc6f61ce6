"""VISinger: VITS-derived singing-voice synthesizer.

Twin of music_generation_tpu/models/svs/visinger.py for the default
configuration (the AE variant, HiFi-GAN decoder, F0 from the F0
predictor). Layout is channels-last [B, T, C] with [B, T, 1] masks, as in
the JAX package, so the two compare like with like.

Ported: SVSConfig, f0_to_coarse, TextEncoder, F0Predictor,
MelPredictNetwork, FramePriorNetwork, TextPostNet, PosteriorEncoder,
SpecDecoder, VISinger.infer / infer_hidden / decode_hidden and the training
forward (VISinger.forward, with dataset or MAS durations). Dropout is
explicit: every forward takes ``deterministic`` (default True) and a
``torch.Generator``, as the flax modules take ``deterministic`` and a
dropout rng; the module's train/eval mode plays no part. The non-AE
variant, NSF excitation, the iSTFT decoders and f0_mode="score" /
f0_residual come with later parts of the port.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core.attention import TransformerEncoder
from ...core.flows import ResidualCouplingBlock
from ...core.layers import Conv1d, conv_ntc
from ...core.masking import (expand_by_durations, feature_mask,
                             rand_slice_segments)
from ...core.wavenet import WaveNet
from ...ops import mas_duration_targets
from ..duration import DurationPredictor
from .hifigan import Generator

_F0_BIN = 256
_F0_MEL_MIN = 1127.0 * math.log(1.0 + 50.0 / 700.0)
_F0_MEL_MAX = 1127.0 * math.log(1.0 + 1100.0 / 700.0)


def f0_to_coarse(f0: torch.Tensor) -> torch.Tensor:
    """Hz -> 1..255 F0 bin (floor(x + 0.5) of the mel-scaled pitch)."""
    mel = 1127.0 * torch.log(1.0 + f0 / 700.0)
    scaled = torch.where(
        mel > 0,
        (mel - _F0_MEL_MIN) * (_F0_BIN - 2) / (_F0_MEL_MAX - _F0_MEL_MIN)
        + 1.0, mel)
    scaled = torch.clamp(scaled, 1.0, _F0_BIN - 1)
    return torch.floor(scaled + 0.5).to(torch.int64)


@dataclasses.dataclass(frozen=True)
class SVSConfig:
    """Model hyperparameters (defaults = VISinger/configs/ours_ae.json)."""
    n_vocab: int = 100
    n_vocab_note: int = 100
    n_vocab_shengdiao: int = 300
    spec_channels: int = 513
    inter_channels: int = 192
    hidden_channels: int = 192
    filter_channels: int = 768
    n_heads: int = 2
    n_layers: int = 6
    kernel_size: int = 3
    p_dropout: float = 0.1
    resblock: str = "1"
    resblock_kernel_sizes: Sequence[int] = (3, 7, 11)
    resblock_dilation_sizes: Sequence[Sequence[int]] = ((1, 3, 5),) * 3
    upsample_rates: Sequence[int] = (8, 8, 2, 2)
    upsample_initial_channel: int = 512
    upsample_kernel_sizes: Sequence[int] = (16, 16, 4, 4)
    segment_size: int = 12288         # samples per training slice
    sampling_rate: int = 22050
    hop_length: int = 256
    frame_seconds: float = 0.0116     # duration->frames divisor

    @property
    def segment_frames(self) -> int:
        return self.segment_size // self.hop_length


def _embedding(n: int, dim: int) -> nn.Embedding:
    emb = nn.Embedding(n, dim)
    nn.init.normal_(emb.weight, std=dim ** -0.5)
    return emb


class TextEncoder(nn.Module):
    def __init__(self, cfg: SVSConfig):
        super().__init__()
        h = self.hidden = cfg.hidden_channels
        self.emb_phoneme = _embedding(cfg.n_vocab, h)
        self.emb_note_pitch = _embedding(cfg.n_vocab_note, h)
        self.emb_note_duration = nn.Linear(1, h)
        self.emb_shengdiao = _embedding(cfg.n_vocab_shengdiao, h)
        self.encoder = TransformerEncoder(h, cfg.filter_channels, cfg.n_heads,
                                          cfg.n_layers, cfg.kernel_size,
                                          cfg.p_dropout)

    def forward(self, phones, note_ids, note_durations, shengdiao, mask,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        emb = (self.emb_phoneme(phones) + self.emb_note_pitch(note_ids)
               + self.emb_note_duration(note_durations[..., None])
               + self.emb_shengdiao(shengdiao)) * math.sqrt(self.hidden)
        return self.encoder(emb * mask, mask, deterministic,
                            generator) * mask


class F0Predictor(nn.Module):
    def __init__(self, cfg: SVSConfig, n_layers: int = 6):
        super().__init__()
        self.encoder = TransformerEncoder(
            cfg.hidden_channels, cfg.filter_channels, cfg.n_heads, n_layers,
            cfg.kernel_size, cfg.p_dropout)
        self.out = Conv1d(cfg.hidden_channels, 1, 1)

    def forward(self, x, mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        h = self.encoder(x * mask, mask, deterministic, generator)
        return (conv_ntc(self.out, h * mask) * mask)[..., 0]


class MelPredictNetwork(nn.Module):
    def __init__(self, cfg: SVSConfig, out_channels: int = 80,
                 n_layers: int = 4):
        super().__init__()
        h = cfg.hidden_channels
        self.condition_proj = Conv1d(h, h, 1)
        self.encoder = TransformerEncoder(h, cfg.filter_channels, cfg.n_heads,
                                          n_layers, cfg.kernel_size,
                                          cfg.p_dropout)
        self.out = Conv1d(h, out_channels, 1)

    def forward(self, x, condition, mask, deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        x = (x + conv_ntc(self.condition_proj, condition)) * mask
        x = self.encoder(x, mask, deterministic, generator)
        return conv_ntc(self.out, x * mask) * mask


class FramePriorNetwork(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 condition_channels: int, n_layers: int = 4):
        super().__init__()
        self.condition_proj = Conv1d(condition_channels, in_channels, 1)
        self.conv = nn.ModuleList(
            Conv1d(in_channels if i == 0 else out_channels, out_channels, 1)
            for i in range(n_layers))

    def forward(self, x, condition, mask):
        x = (x + conv_ntc(self.condition_proj, condition)) * mask
        for conv in self.conv:
            x = F.gelu(conv_ntc(conv, x), approximate="tanh") * mask
        return x


class TextPostNet(nn.Module):
    """Position emb -> F0 predictor -> mel predictor -> frame prior ->
    (m, logs)."""

    def __init__(self, cfg: SVSConfig, max_positions: int = 2000,
                 n_mels: int = 80):
        super().__init__()
        h = cfg.hidden_channels
        self.inter = cfg.inter_channels
        self.position_embeddings = _embedding(max_positions, h)
        self.f0_predictor = F0Predictor(cfg)
        self.f0_emb = _embedding(300, h)
        self.mel_predict_net = MelPredictNetwork(cfg, n_mels)
        self.frame_prior_net = FramePriorNetwork(n_mels, h, h)
        self.proj = Conv1d(h, 2 * cfg.inter_channels, 1)

    def forward(self, x, mask, f0_score: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """``f0_score`` [B, T] int coarse F0 (training: the batch's ground
        truth) drives the F0 embedding; None takes it from the predicted
        log-F0."""
        t = x.shape[1]
        x_emb = (x + self.position_embeddings.weight[None, :t]) * mask
        log_f0 = self.f0_predictor(x_emb, mask, deterministic, generator)
        if f0_score is None:
            f0_score = f0_to_coarse(torch.exp(log_f0) - 1.0)
        f0_emb = self.f0_emb(f0_score) * mask
        mel_predict = self.mel_predict_net(x_emb, f0_emb, mask, deterministic,
                                           generator)
        x_hidden = self.frame_prior_net(mel_predict, f0_emb, mask)
        stats = conv_ntc(self.proj, x_hidden * mask) * mask
        return (stats[..., :self.inter], stats[..., self.inter:], log_f0,
                mel_predict)


class PosteriorEncoder(nn.Module):
    def __init__(self, cfg: SVSConfig):
        super().__init__()
        h = cfg.hidden_channels
        self.inter = cfg.inter_channels
        self.pre = Conv1d(cfg.spec_channels, h, 1)
        self.enc = WaveNet(h, 5, 1, 16)
        self.proj = Conv1d(h, 2 * cfg.inter_channels, 1)

    def forward(self, spec, mask, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None):
        x = conv_ntc(self.pre, spec) * mask
        x = self.enc(x, mask)
        stats = conv_ntc(self.proj, x) * mask
        m, logs = stats[..., :self.inter], stats[..., self.inter:]
        if noise is None:
            noise = torch.randn(m.shape, generator=generator,
                                device=m.device, dtype=m.dtype)
        z = (m + noise * torch.exp(logs)) * mask
        return z, m, logs, x


class SpecDecoder(nn.Module):
    """z -> predicted linear spectrogram (AE variant)."""

    def __init__(self, cfg: SVSConfig):
        super().__init__()
        h = cfg.hidden_channels
        self.pre = Conv1d(cfg.inter_channels, h, 1)
        self.enc = WaveNet(h, 5, 1, 16)
        self.proj = Conv1d(h, cfg.spec_channels, 1)

    def forward(self, x, mask):
        x = conv_ntc(self.pre, x) * mask
        x = self.enc(x, mask)
        return conv_ntc(self.proj, x) * mask


class VISinger(nn.Module):
    """AE variant with the HiFi-GAN decoder. Methods:
      - infer(...): score -> waveform
      - forward(...): the training forward (pieces for the GAN/VAE losses)
    """

    def __init__(self, cfg: SVSConfig):
        super().__init__()
        c = self.cfg = cfg
        self.text_encoder = TextEncoder(c)
        self.duration_predictor = DurationPredictor(c.hidden_channels, 256, 3,
                                                    0.5)
        self.text_post_net = TextPostNet(c)
        self.spec_encoder = PosteriorEncoder(c)
        self.spec_flow = ResidualCouplingBlock(
            c.inter_channels, c.hidden_channels, 5, 1, 4)
        self.decoder = Generator(
            c.inter_channels, c.resblock, tuple(c.resblock_kernel_sizes),
            tuple(tuple(d) for d in c.resblock_dilation_sizes),
            tuple(c.upsample_rates), c.upsample_initial_channel,
            tuple(c.upsample_kernel_sizes))
        self.spec_decoder = SpecDecoder(c)
        self.spec_proj = Conv1d(c.spec_channels, c.inter_channels, 1)

    def infer(self, phones, x_lengths, note_ids, note_durations, shengdiao,
              max_frames: int, noise_scale: float = 1.0,
              ph_dur: Optional[torch.Tensor] = None,
              noise: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None):
        """Score -> waveform.

        phones/note_ids/shengdiao: int [B, T]; note_durations: f32 [B, T]
        seconds; x_lengths: int [B]. ``noise`` [B, max_frames, inter]
        replaces the prior sample drawn from ``generator``; ``ph_dur`` [B, T]
        int frames replaces the predicted durations. Returns (audio
        [B, max_frames*hop, 1], mel_len [B], aux dict).
        """
        hidden, mel_len, aux = self.infer_hidden(
            phones, x_lengths, note_ids, note_durations, shengdiao,
            max_frames, noise_scale=noise_scale, ph_dur=ph_dur, noise=noise,
            generator=generator)
        return self.decode_hidden(hidden), mel_len, aux

    def infer_hidden(self, phones, x_lengths, note_ids, note_durations,
                     shengdiao, max_frames: int, noise_scale: float = 1.0,
                     ph_dur: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """infer() up to (excluding) the vocoder: the decoder input
        [B, max_frames, inter], mel_len [B] and the aux dict."""
        c = self.cfg
        x_mask = feature_mask(x_lengths, phones.shape[1])
        h_text = self.text_encoder(phones, note_ids, note_durations,
                                   shengdiao, x_mask)
        aux = {}
        if ph_dur is None:
            frac = self.duration_predictor(h_text, x_mask)
            aux["frac"] = frac
            frames = torch.floor(frac * note_durations / c.frame_seconds
                                 ).to(torch.int32)
        else:
            frames = ph_dur
        frames = frames * x_mask[..., 0].to(frames.dtype)

        h_lr, mel_len = expand_by_durations(h_text, frames, max_frames)
        mel_len = torch.clamp(mel_len, max=max_frames)
        y_mask = feature_mask(mel_len, max_frames)
        m_p, logs_p, log_f0, mel_predict = self.text_post_net(h_lr, y_mask)
        if noise is None:
            noise = torch.randn(m_p.shape, generator=generator,
                                device=m_p.device, dtype=m_p.dtype)
        z_p = m_p + noise * torch.exp(logs_p) * noise_scale
        z = self.spec_flow(z_p, y_mask, reverse=True)
        spec_predict = self.spec_decoder(z, y_mask)
        hidden = conv_ntc(self.spec_proj, spec_predict) * y_mask
        aux.update(log_f0=log_f0, log_f0_used=log_f0 * y_mask[..., 0],
                   mel_predict=mel_predict, spec_predict=spec_predict,
                   frames=frames)
        return hidden, mel_len, aux

    def decode_hidden(self, hidden: torch.Tensor) -> torch.Tensor:
        """Vocoder decoder only (pairs with infer_hidden)."""
        return self.decoder(hidden)

    def _posterior(self, spec, y_lengths, noise=None, generator=None):
        """Posterior sample and its flow image: (z, m_q, logs_q, y_mask,
        z_p)."""
        y_mask = feature_mask(y_lengths, spec.shape[1])
        z, m_q, logs_q, _ = self.spec_encoder(spec, y_mask, noise=noise,
                                              generator=generator)
        return z, m_q, logs_q, y_mask, self.spec_flow(z, y_mask)

    def _token_prior(self, h_text, x_mask, deterministic=True,
                     generator=None):
        """The token-level prior MAS aligns against: text_post_net on the
        UN-regulated text encoding, F0 embedding from its own prediction."""
        m_tok, logs_tok, _, _ = self.text_post_net(
            h_text, x_mask, deterministic=deterministic, generator=generator)
        return m_tok, logs_tok

    def mas_inputs(self, phones, x_lengths, note_ids, note_durations,
                   shengdiao, spec, y_lengths,
                   noise: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
        """The tensors the training forward aligns with MAS
        (visinger.py:524-534 of the JAX package): the posterior sample
        through the flow z_p [B, F, inter], the token-level prior m, logs
        [B, T, inter] and the masks. Feed them to ops.mas_duration_targets."""
        x_mask = feature_mask(x_lengths, phones.shape[1])
        h_text = self.text_encoder(phones, note_ids, note_durations,
                                   shengdiao, x_mask)
        _, _, _, y_mask, z_p = self._posterior(spec, y_lengths, noise,
                                               generator)
        m_tok, logs_tok = self._token_prior(h_text, x_mask)
        return z_p, m_tok, logs_tok, x_mask, y_mask

    def forward(self, phones, x_lengths, spec, y_lengths, note_ids,
                note_durations, f0_score, phone_durations, shengdiao,
                deterministic: bool = False, use_mas: bool = False, *,
                noise: Optional[torch.Tensor] = None,
                noise_rev: Optional[torch.Tensor] = None,
                slice_u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """Training forward (the JAX package's VISinger.__call__).

        Batch tensors as train.data.BATCH_KEYS gives them. With ``use_mas``
        the durations that drive the length regulator and the duration loss
        come from monotonic alignment search of the posterior against the
        token-level prior (detached; CUDA tensors launch the MAS kernel),
        else from ``phone_durations``. The three random draws, the
        posterior noise [B, F, inter], the reverse-KL noise [B, F, inter]
        and the slice-start uniforms [B], may be passed in; otherwise they,
        and the dropout masks when ``deterministic`` is False, come from
        ``generator``."""
        c = self.cfg
        x_mask = feature_mask(x_lengths, phones.shape[1])
        h_text = self.text_encoder(phones, note_ids, note_durations,
                                   shengdiao, x_mask, deterministic,
                                   generator)
        duration_fraction = self.duration_predictor(h_text, x_mask,
                                                    deterministic, generator)
        max_frames = spec.shape[1]
        z, m_q, logs_q, y_mask, z_p = self._posterior(spec, y_lengths, noise,
                                                      generator)
        if use_mas:
            with torch.no_grad():
                m_tok, logs_tok = self._token_prior(h_text, x_mask,
                                                    deterministic, generator)
            phone_durations = mas_duration_targets(
                z_p.detach(), m_tok, logs_tok, x_mask, y_mask)

        h_lr, _ = expand_by_durations(h_text, phone_durations, max_frames)
        m_p, logs_p, log_f0, mel_predict = self.text_post_net(
            h_lr, y_mask, f0_score=f0_score, deterministic=deterministic,
            generator=generator)

        if noise_rev is None:
            noise_rev = torch.randn(m_p.shape, generator=generator,
                                    device=m_p.device, dtype=m_p.dtype)
        z_hat = self.spec_flow(m_p + noise_rev * torch.exp(logs_p), y_mask,
                               reverse=True)

        spec_predict = self.spec_decoder(z, y_mask)
        dec_input = conv_ntc(self.spec_proj, spec_predict)
        z_slice, ids_slice = rand_slice_segments(
            dec_input, y_lengths, c.segment_frames, u=slice_u,
            generator=generator)
        return {
            "audio": self.decoder(z_slice),
            "duration_fraction": duration_fraction,
            # the durations that drove the length regulator (the batch's,
            # or the in-step MAS targets): the duration loss's targets
            "duration_targets": phone_durations,
            "ids_slice": ids_slice,
            "x_mask": x_mask, "y_mask": y_mask,
            "z": z, "z_p": z_p, "m_p": m_p, "logs_p": logs_p,
            "m_q": m_q, "logs_q": logs_q,
            "log_f0": log_f0,
            "mel_predict": mel_predict,
            "spec_predict": spec_predict,
            "z_hat": z_hat,
        }
