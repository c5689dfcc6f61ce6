"""VISinger: VITS-derived singing-voice synthesizer.

Twin of music_generation_tpu/models/svs/visinger.py, the AE variant
(SpecDecoder + spec_proj) or, with ``autoencoder=False``, the plain one
that decodes z itself, with the HiFi-GAN (optionally with the NSF harmonic
source), iSTFT or MB-iSTFT decoder. Layout is channels-last [B, T, C] with
[B, T, 1] masks, as in the JAX package, so the two compare like with like.

Ported: SVSConfig, f0_to_coarse, note_hz_frames, TextEncoder, F0Predictor
(absolute or residual head), MelPredictNetwork, FramePriorNetwork,
TextPostNet, PosteriorEncoder, SpecDecoder, VISinger.infer / infer_hidden /
decode_hidden (F0 from the predictor or the score, the NSF source, the
decoder in bfloat16), the probes infer_fake / copy_synthesis /
voice_conversion (speaker conditioning g [B, 1, gin_channels]) and the
training forward (VISinger.forward, with dataset or MAS durations).
Dropout is explicit: every forward takes ``deterministic`` (default True)
and a ``torch.Generator``, as the flax modules take ``deterministic`` and a
dropout rng; the module's train/eval mode plays no part.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ...core import draws
from ...core.attention import TransformerEncoder
from ...core.flows import ResidualCouplingBlock
from ...core.layers import Conv1d, conv_ntc
from ...core.masking import (expand_by_durations, feature_mask,
                             rand_slice_segments, slice_segments)
from ...core.wavenet import WaveNet
from ...mas import mas_duration_targets
from ..duration import DurationPredictor
from .excitation import harmonic_excitation
from .hifigan import Generator
from .istft import ISTFTGenerator, MBISTFTGenerator

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


def note_hz_frames(note_ids: torch.Tensor, frames: torch.Tensor,
                   max_frames: int) -> torch.Tensor:
    """Per-frame Hz of the score's MIDI notes (0 at rests, note id 0),
    length-regulated with the same per-phone frame counts as the text
    hidden: the pitch base of f0_mode="score" and of the residual F0 head.
    [B, T_phones] int note ids -> [B, max_frames] float32."""
    hz = torch.where(note_ids > 0,
                     440.0 * torch.exp2((note_ids.float() - 69.0) / 12.0),
                     0.0)
    hz_fr, _ = expand_by_durations(hz[..., None], frames, max_frames)
    return hz_fr[..., 0]


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
    # speaker conditioning width: > 0 builds the cond convs of the
    # posterior encoder, the flow and the decoder, which take g
    # [B, 1, gin_channels] (voice_conversion); 0 builds none
    gin_channels: int = 0
    # the AE variant (SpecDecoder + spec_proj before the vocoder); False
    # is the plain variant, whose vocoder decodes z itself
    autoencoder: bool = True
    # vocoder decoder family (models/svs/istft.py): "hifigan" (reference
    # parity), "istft" (an iSTFT head replaces the last upsample stages) or
    # "mb_istft" (+ PQMF subbands); istft_upsample_rates * istft_hop
    # (* mb_subbands) must equal hop_length
    decoder_type: str = "hifigan"
    istft_n_fft: int = 16
    istft_hop: int = 4
    istft_upsample_rates: Sequence[int] = (8, 8)
    istft_upsample_kernel_sizes: Sequence[int] = (16, 16)
    mb_subbands: int = 4
    mb_upsample_rates: Sequence[int] = (4, 4)
    mb_upsample_kernel_sizes: Sequence[int] = (8, 8)
    sampling_rate: int = 22050
    hop_length: int = 256
    frame_seconds: float = 0.0116     # duration->frames divisor
    # run the vocoder decoder (any family) in bfloat16 at inference; the
    # parameters stay float32 and the output comes back float32
    decoder_bf16: bool = False
    # NSF harmonic excitation (models/svs/excitation.py): the HiFi-GAN
    # decoder also gets a sample-rate sine source at the frame F0 (the
    # batch's log_f0 in training, log_f0_used at inference); hifigan only
    nsf: bool = False
    # inference F0 source: "predict" (the F0 predictor drives the F0
    # embedding and the NSF source) or "score" (both from the score's MIDI
    # notes); training always takes the batch's F0
    f0_mode: str = "predict"
    # residual F0 head: the zero-initialised predictor output is a
    # deviation added to the note's frame log1p-F0, in training and at
    # inference; the parameters are those of the absolute head
    f0_residual: bool = False

    @property
    def hop_seconds(self) -> float:
        return self.hop_length / self.sampling_rate

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
    """Frame log1p-F0 from the frame hidden; ``zero_init`` starts the
    output conv at zero (the residual head starts on the note pitch)."""

    def __init__(self, cfg: SVSConfig, n_layers: int = 6,
                 zero_init: bool = False):
        super().__init__()
        self.encoder = TransformerEncoder(
            cfg.hidden_channels, cfg.filter_channels, cfg.n_heads, n_layers,
            cfg.kernel_size, cfg.p_dropout)
        self.out = Conv1d(cfg.hidden_channels, 1, 1,
                          init_scale=0.0 if zero_init else 1.0)

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
        self.f0_predictor = F0Predictor(cfg, zero_init=cfg.f0_residual)
        self.f0_emb = _embedding(300, h)
        self.mel_predict_net = MelPredictNetwork(cfg, n_mels)
        self.frame_prior_net = FramePriorNetwork(n_mels, h, h)
        self.proj = Conv1d(h, 2 * cfg.inter_channels, 1)

    def forward(self, x, mask, f0_score: Optional[torch.Tensor] = None,
                lf0_base: Optional[torch.Tensor] = None,
                deterministic: bool = True,
                generator: Optional[torch.Generator] = None):
        """``f0_score`` [B, T] int coarse F0 (training: the batch's ground
        truth; f0_mode="score": the note pitch) drives the F0 embedding;
        None takes it from the predicted log-F0. ``lf0_base`` [B, T] (the
        residual head) is added to the predictor's output."""
        t = x.shape[1]
        x_emb = (x + self.position_embeddings.weight[None, :t]) * mask
        log_f0 = self.f0_predictor(x_emb, mask, deterministic, generator)
        if lf0_base is not None:
            log_f0 = (log_f0 + lf0_base) * mask[..., 0]
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
        self.enc = WaveNet(h, 5, 1, 16, cfg.gin_channels)
        self.proj = Conv1d(h, 2 * cfg.inter_channels, 1)

    def forward(self, spec, mask, noise: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None,
                g: Optional[torch.Tensor] = None):
        x = conv_ntc(self.pre, spec) * mask
        x = self.enc(x, mask, g)
        stats = conv_ntc(self.proj, x) * mask
        m, logs = stats[..., :self.inter], stats[..., self.inter:]
        if noise is None:
            noise = draws.randn(m.shape, generator=generator,
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
    """The AE or plain variant (``cfg.autoencoder``) with the HiFi-GAN,
    iSTFT or MB-iSTFT decoder (``cfg.decoder_type``; ``cfg.nsf`` gives the
    HiFi-GAN decoder the harmonic source). Methods:
      - infer(...): score -> waveform
      - infer_fake / copy_synthesis / voice_conversion: spectrogram probes
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
            c.inter_channels, c.hidden_channels, 5, 1, 4,
            gin_channels=c.gin_channels)
        trunk = (c.inter_channels, c.resblock,
                 tuple(c.resblock_kernel_sizes),
                 tuple(tuple(d) for d in c.resblock_dilation_sizes))
        gin = {"gin_channels": c.gin_channels}
        if c.decoder_type == "istft":
            up = math.prod(c.istft_upsample_rates) * c.istft_hop
            assert up == c.hop_length, (up, c.hop_length)
            self.decoder = ISTFTGenerator(
                *trunk, tuple(c.istft_upsample_rates),
                c.upsample_initial_channel,
                tuple(c.istft_upsample_kernel_sizes), c.istft_n_fft,
                c.istft_hop, **gin)
        elif c.decoder_type == "mb_istft":
            up = (math.prod(c.mb_upsample_rates) * c.istft_hop
                  * c.mb_subbands)
            assert up == c.hop_length, (up, c.hop_length)
            self.decoder = MBISTFTGenerator(
                *trunk, tuple(c.mb_upsample_rates),
                c.upsample_initial_channel,
                tuple(c.mb_upsample_kernel_sizes), c.istft_n_fft,
                c.istft_hop, c.mb_subbands, **gin)
        else:
            assert c.decoder_type == "hifigan", c.decoder_type
            self.decoder = Generator(
                *trunk, tuple(c.upsample_rates), c.upsample_initial_channel,
                tuple(c.upsample_kernel_sizes), nsf=c.nsf, **gin)
        if c.nsf:
            assert c.decoder_type == "hifigan", (
                "NSF excitation is wired for the hifigan decoder only")
        assert c.f0_mode in ("predict", "score"), c.f0_mode
        if c.autoencoder:
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
        return self.decode_hidden(hidden, aux.get("exc")), mel_len, aux

    def infer_hidden(self, phones, x_lengths, note_ids, note_durations,
                     shengdiao, max_frames: int, noise_scale: float = 1.0,
                     ph_dur: Optional[torch.Tensor] = None,
                     noise: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None):
        """infer() up to (excluding) the vocoder: the decoder input
        [B, max_frames, inter], mel_len [B] and the aux dict: log_f0 (the
        predictor's), log_f0_used (the F0 the decoder's source follows),
        mel_predict, spec_predict (None in the plain variant), frames, and
        with ``cfg.nsf`` exc, the full-length harmonic source
        [B, max_frames * hop, 1]."""
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
        f0_coarse = lf0_score = lf0_base = None
        if c.f0_mode == "score" or c.f0_residual:
            # frame F0 from the score's notes (0 Hz at rests), expanded
            # with the same frame counts as the text hidden
            hz_fr = note_hz_frames(note_ids, frames,
                                   max_frames) * y_mask[..., 0]
            if c.f0_mode == "score":
                lf0_score = torch.log1p(hz_fr)
                f0_coarse = f0_to_coarse(hz_fr)
            if c.f0_residual:
                lf0_base = torch.log1p(hz_fr)
        m_p, logs_p, log_f0, mel_predict = self.text_post_net(
            h_lr, y_mask, f0_score=f0_coarse, lf0_base=lf0_base)
        if noise is None:
            noise = torch.randn(m_p.shape, generator=generator,
                                device=m_p.device, dtype=m_p.dtype)
        z_p = m_p + noise * torch.exp(logs_p) * noise_scale
        z = self.spec_flow(z_p, y_mask, reverse=True)
        hidden, spec_predict = self._vocoder_input(z, y_mask)
        lf0_used = (lf0_score if lf0_score is not None
                    else log_f0 * y_mask[..., 0])
        aux.update(log_f0=log_f0, log_f0_used=lf0_used,
                   mel_predict=mel_predict, spec_predict=spec_predict,
                   frames=frames)
        if c.nsf:
            # full length, so a slice or window of it keeps its phase
            aux["exc"] = self.excitation(lf0_used)
        return hidden, mel_len, aux

    def excitation(self, log_f0: torch.Tensor) -> torch.Tensor:
        """Frame log1p-F0 [B, T] -> NSF sine source [B, T*hop, 1]."""
        return harmonic_excitation(log_f0, self.cfg.hop_length,
                                   self.cfg.sampling_rate)

    def _vocoder_input(self, z, y_mask):
        """(hidden, spec_predict): the vocoder's input on the trained path,
        z -> spec decoder -> spec_proj in the AE variant, z itself (and no
        spec_predict) in the plain one."""
        if not self.cfg.autoencoder:
            return z * y_mask, None
        spec_predict = self.spec_decoder(z, y_mask)
        return conv_ntc(self.spec_proj, spec_predict) * y_mask, spec_predict

    def decode_hidden(self, hidden: torch.Tensor,
                      exc: Optional[torch.Tensor] = None,
                      g: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Vocoder decoder only (pairs with infer_hidden; ``exc`` is its
        aux["exc"] under ``cfg.nsf``, ``g`` [B, 1, gin_channels] the
        speaker conditioning). With ``cfg.decoder_bf16`` the decoder runs
        in bfloat16 and its output comes back float32: the hidden state is
        cast here, and each conv casts its float32 effective weight at use
        (core.layers), so the module and its state_dict stay float32."""
        kw = {} if exc is None else {"exc": exc}
        if g is not None:
            kw["g"] = g
        if self.cfg.decoder_bf16:
            return self.decoder(hidden.to(torch.bfloat16), **kw).float()
        return self.decoder(hidden, **kw)

    def _latent_to_audio(self, z, y_mask, log_f0=None):
        """(audio, spec_predict) of a posterior z through the trained
        decode path; ``log_f0`` drives the NSF source."""
        hidden, spec_predict = self._vocoder_input(z, y_mask)
        exc = (self.excitation(log_f0) if self.cfg.nsf and log_f0 is not None
               else None)
        return self.decode_hidden(hidden, exc), spec_predict

    def infer_fake(self, spec, y_lengths, max_len: Optional[int] = None,
                   noise: Optional[torch.Tensor] = None,
                   log_f0: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
        """Copy synthesis as the reference writes it: spectrogram [B, F,
        spec_channels] -> posterior z -> the vocoder, straight from z in
        both variants (the reference's decoder(z) bypass of the AE spec
        decoder). ``max_len`` keeps the first frames (the mask and, under
        NSF, the source sliced with z); ``log_f0`` [B, F] drives the NSF
        source; ``noise`` replaces the posterior draw. Returns (audio,
        y_mask, z)."""
        y_mask = feature_mask(y_lengths, spec.shape[1])
        z, _, _, _ = self.spec_encoder(spec, y_mask, noise=noise,
                                       generator=generator)
        z = z * y_mask
        exc = (self.excitation(log_f0) if self.cfg.nsf and log_f0 is not None
               else None)
        if max_len is not None:
            z, y_mask = z[:, :max_len], y_mask[:, :max_len]
            if exc is not None:
                exc = exc[:, :max_len * self.cfg.hop_length]
        return self.decode_hidden(z, exc), y_mask, z

    def copy_synthesis(self, spec, y_lengths,
                       noise: Optional[torch.Tensor] = None,
                       log_f0: Optional[torch.Tensor] = None,
                       generator: Optional[torch.Generator] = None):
        """Spectrogram -> posterior z -> the trained decode path (the spec
        decoder in the AE variant) -> waveform: the reconstruction the
        training objective optimises. Returns (audio, y_mask, z)."""
        y_mask = feature_mask(y_lengths, spec.shape[1])
        z, _, _, _ = self.spec_encoder(spec, y_mask, noise=noise,
                                       generator=generator)
        audio, _ = self._latent_to_audio(z, y_mask, log_f0=log_f0)
        return audio, y_mask, z

    def voice_conversion(self, spec, y_lengths,
                         g_src: Optional[torch.Tensor] = None,
                         g_tgt: Optional[torch.Tensor] = None,
                         noise: Optional[torch.Tensor] = None,
                         generator: Optional[torch.Generator] = None):
        """Posterior under ``g_src`` -> flow -> inverse flow under ``g_tgt``
        -> the vocoder under ``g_tgt``, straight from z_hat as the
        reference does (g: [B, 1, gin_channels] or None). Returns (audio,
        y_mask, (z, z_p, z_hat))."""
        y_mask = feature_mask(y_lengths, spec.shape[1])
        z, _, _, _ = self.spec_encoder(spec, y_mask, noise=noise,
                                       generator=generator, g=g_src)
        z_p = self.spec_flow(z, y_mask, g_src)
        z_hat = self.spec_flow(z_p, y_mask, g_tgt, reverse=True)
        return (self.decode_hidden(z_hat * y_mask, g=g_tgt), y_mask,
                (z, z_p, z_hat))

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
                log_f0: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None,
                noise_rev: Optional[torch.Tensor] = None,
                slice_u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict:
        """Training forward (the JAX package's VISinger.__call__).

        Batch tensors as train.data.BATCH_KEYS gives them; ``log_f0`` is
        the batch's frame log-F0, which drives the NSF source (needed with
        ``cfg.nsf``; never the predicted F0). With ``use_mas``
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
        lf0_base = None
        if c.f0_residual:
            # the head trains against (batch lf0 - note lf0), the notes
            # expanded by the durations that drove the length regulator
            lf0_base = torch.log1p(note_hz_frames(
                note_ids, phone_durations, max_frames)) * y_mask[..., 0]
        # the predicted F0 stays apart from the batch's log_f0, which alone
        # drives the NSF source below
        m_p, logs_p, log_f0_pred, mel_predict = self.text_post_net(
            h_lr, y_mask, f0_score=f0_score, lf0_base=lf0_base,
            deterministic=deterministic, generator=generator)

        if noise_rev is None:
            noise_rev = draws.randn(m_p.shape, generator=generator,
                                    device=m_p.device, dtype=m_p.dtype)
        z_hat = self.spec_flow(m_p + noise_rev * torch.exp(logs_p), y_mask,
                               reverse=True)

        if c.autoencoder:
            spec_predict = self.spec_decoder(z, y_mask)
            dec_input = conv_ntc(self.spec_proj, spec_predict)
        else:
            spec_predict, dec_input = None, z
        z_slice, ids_slice = rand_slice_segments(
            dec_input, y_lengths, c.segment_frames, u=slice_u,
            generator=generator)
        exc = None
        if c.nsf:
            if log_f0 is None:
                raise ValueError("cfg.nsf training needs the batch's log_f0")
            exc = slice_segments(self.excitation(log_f0),
                                 ids_slice * c.hop_length, c.segment_size)
        return {
            "audio": self.decoder(z_slice) if exc is None
            else self.decoder(z_slice, exc),
            "duration_fraction": duration_fraction,
            # the durations that drove the length regulator (the batch's,
            # or the in-step MAS targets): the duration loss's targets
            "duration_targets": phone_durations,
            "ids_slice": ids_slice,
            "x_mask": x_mask, "y_mask": y_mask,
            "z": z, "z_p": z_p, "m_p": m_p, "logs_p": logs_p,
            "m_q": m_q, "logs_q": logs_q,
            "log_f0": log_f0_pred,
            "mel_predict": mel_predict,
            "spec_predict": spec_predict,
            "z_hat": z_hat,
        }
