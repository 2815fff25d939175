"""Top-level TTS model.

Counterpart of ``radmmm_tpu/models/tts.py``: ``TTSConfig``,
``default_radmmm_config`` and ``TTSModel`` with

* the training forward ``forward(batch, binarize, train, generator)``:
  text encoder, alignment attention (hard MAS alignment when
  ``binarize``), context = attn @ txt_enc, the flow mel -> z, and the four
  attribute predictors on the detached context, the frame-level three
  ganged into one six-lane recurrence as in serving;
* the serving stages ``infer_durations`` (text -> encoder states and token
  durations) and ``infer_decode`` (length regulation, voiced/F0/energy
  prediction, F0 stat shifting, flow sampling, mel descale), and ``infer``
  composing both;
* ``reconstruct``: MAS durations from a featurized batch's own mel, then
  the flow sampled on its ground-truth F0 and energy.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from radmmm_torch.models.attributes import ConvLSTMLinearDAP, LSTMConvDAP
from radmmm_torch.models.encoder import TextEncoder
from radmmm_torch.models.flow_decoder import RADMMMFlow
from radmmm_torch.ops.alignment import binarize_attention
from radmmm_torch.ops.attention import ConvAttention
from radmmm_torch.ops.invertible import InvertibleLU, WhiteningConv
from radmmm_torch.ops.length_regulator import regulate_length
from radmmm_torch.ops.lstm import multi_bilstm_scan
from radmmm_torch.utils.masking import SeqLens
from radmmm_torch.utils.profiling import train_span


@dataclasses.dataclass(frozen=True)
class TTSConfig:
    """Hyperparameters of the shipped RADMMM recipe (same fields and
    defaults as the JAX package's TTSConfig)."""
    n_text_tokens: int = 426
    n_text_dim: int = 512
    n_speakers: int = 7
    n_speaker_dim: int = 16
    n_augmentations: int = 0
    use_accent: bool = True
    n_accents: int = 7
    n_accent_dim: int = 8
    n_mel_channels: int = 80
    use_accent_emb_for_encoder: bool = True
    use_accent_emb_for_decoder: bool = False
    use_accent_emb_for_alignment: bool = False
    use_speaker_emb_for_alignment: bool = True
    encoder_n_convolutions: int = 3
    encoder_kernel_size: int = 5
    encoder_p_dropout: float = 0.5
    lstm_norm_fn: Optional[str] = "spectral"
    scale_mel: bool = True
    f0_loss_voiced_only: bool = True
    gang_frame_predictors: bool = True
    decoder: Dict[str, Any] = dataclasses.field(default_factory=dict)
    f0_predictor: Optional[Dict[str, Any]] = None
    energy_predictor: Optional[Dict[str, Any]] = None
    voiced_predictor: Optional[Dict[str, Any]] = None
    duration_predictor: Optional[Dict[str, Any]] = None

    @property
    def total_speakers(self) -> int:
        return self.n_speakers * (1 + self.n_augmentations)

    @property
    def encoder_dim(self) -> int:
        return self.n_text_dim + (self.n_accent_dim
                                  if self.use_accent_emb_for_encoder else 0)


def default_radmmm_config(**overrides) -> TTSConfig:
    """The shipped 7-language RADMMM recipe: text dim 512 (+8 accent = 520
    into the encoder, decoder and predictors), 8 flows of 4 WN layers with
    1024 channels, n_group_size 2, four ConvLSTMLinearDAP predictors."""
    cfg = dict(
        n_augmentations=2,
        decoder=dict(n_speaker_dim=16, use_accent=True, n_accent_dim=8,
                     n_text_dim=520, use_context_lstm=True,
                     context_lstm_norm=None, n_f0_dims=1,
                     n_energy_avg_dims=1, context_w_f0_and_energy=True,
                     n_mel_channels=80, n_flows=8,
                     n_conv_layers_per_step=4, n_early_size=2,
                     n_early_every=2, n_group_size=2, affine_model="wavenet",
                     scaling_fn="tanh", affine_activation="softplus",
                     use_partial_padding=True,
                     use_accent_emb_for_decoder=False),
    )
    dap = dict(n_speaker_dim=16, n_accent_dim=8, use_accent_embedding=True,
               in_dim=520, out_dim=1, reduction_factor=16,
               n_backbone_layers=3, n_hidden=256, kernel_size=5,
               p_dropout=0.5, lstm_type="bilstm")
    cfg["f0_predictor"] = dict(dap, target_offset=-5.0)
    cfg["energy_predictor"] = dict(dap, target_offset=-0.75)
    cfg["voiced_predictor"] = dict(dap)
    cfg["duration_predictor"] = dict(dap, log_target=True)
    cfg.update(overrides)
    return TTSConfig(**cfg)


def mel_scale(mel):
    return (mel + 5.0) / 2.0


def mel_descale(mel):
    return mel * 2.0 - 5.0


_PREDICTORS = ("f0_predictor", "energy_predictor", "voiced_predictor",
               "duration_predictor")
# a predictor config's ``_class`` (the reference's class_path)
_DAP_CLASSES = {"ConvLSTMLinearDAP": ConvLSTMLinearDAP,
                "LSTMConvDAP": LSTMConvDAP}


class TTSModel(nn.Module):
    def __init__(self, config: TTSConfig):
        super().__init__()
        c = self.config = config
        self.text_embeddings = nn.Embedding(c.n_text_tokens, c.n_text_dim)
        self.speaker_embeddings = nn.Embedding(c.total_speakers,
                                               c.n_speaker_dim)
        if c.use_accent:
            self.accent_embeddings = nn.Embedding(c.n_accents,
                                                  c.n_accent_dim)
        self.text_encoder = TextEncoder(c.encoder_n_convolutions,
                                        c.encoder_dim, c.encoder_kernel_size,
                                        c.lstm_norm_fn, c.encoder_p_dropout)
        attention_key_dim = c.n_text_dim
        if c.use_accent_emb_for_alignment:
            attention_key_dim += c.n_accent_dim
        elif c.use_speaker_emb_for_alignment:
            attention_key_dim += c.n_speaker_dim
        self.attention = ConvAttention(c.n_mel_channels, attention_key_dim)
        self.decoder = RADMMMFlow(**c.decoder)
        for attr in _PREDICTORS:
            pcfg = getattr(c, attr)
            if pcfg is None:
                setattr(self, attr, None)
                continue
            pcfg = dict(pcfg)
            cls_name = pcfg.pop("_class", "ConvLSTMLinearDAP")
            if cls_name not in _DAP_CLASSES:
                raise ValueError(f"{attr}: unknown predictor class "
                                 f"{cls_name}")
            setattr(self, attr, _DAP_CLASSES[cls_name](**pcfg))

    def cache_inverses(self) -> "TTSModel":
        """Compute every flow 1x1 inverse once (after the weights are
        loaded and the model is on its device)."""
        for m in self.modules():
            if isinstance(m, (InvertibleLU, WhiteningConv)):
                m.cache_inverse()
        return self

    # ---- pieces -----------------------------------------------------------
    def encode_text(self, text, lens: SeqLens, accent_vecs=None,
                    train: bool = False,
                    generator: Optional[torch.Generator] = None):
        """-> (txt_enc (B,T,encoder_dim), txt_emb (B,T,n_text_dim))."""
        txt_emb = self.text_embeddings(text)
        enc_in = txt_emb
        if accent_vecs is not None and self.config.use_accent_emb_for_encoder:
            enc_in = torch.cat(
                [txt_emb,
                 accent_vecs[:, None, :].expand(*txt_emb.shape[:2], -1)],
                dim=-1)
        return (self.text_encoder(enc_in, lens.mask, train=train,
                                  generator=generator), txt_emb)

    def compute_attention(self, mel, txt_emb, spk_vecs, accent_vecs,
                          out_lens: SeqLens, in_lens: SeqLens, attn_prior,
                          binarize: bool):
        """(attn, attn_soft, attn_hard, attn_logprob). The keys are the
        text embeddings with the detached speaker (or accent) vector; with
        ``binarize`` attn is the detached hard MAS alignment."""
        c = self.config
        extra = (accent_vecs if c.use_accent_emb_for_alignment
                 else spk_vecs if c.use_speaker_emb_for_alignment else None)
        keys = txt_emb
        if extra is not None:
            keys = torch.cat([keys, extra.detach()[:, None, :].expand(
                *keys.shape[:2], -1)], dim=-1)
        attn_soft, attn_logprob = self.attention(
            mel, keys, key_mask=in_lens.mask, attn_prior=attn_prior)
        attn_hard = None
        attn = attn_soft
        if binarize:
            attn = attn_hard = binarize_attention(attn_soft, in_lens.lengths,
                                                  out_lens.lengths)
        return attn, attn_soft, attn_hard, attn_logprob

    def _gangable(self, mods) -> bool:
        """True when the frame-level predictors' BiLSTMs have identical
        shapes and run as one multi-lane recurrence."""
        if not self.config.gang_frame_predictors or len(mods) < 2:
            return False
        if not all(isinstance(m, ConvLSTMLinearDAP) for m in mods):
            return False
        return all(m.lstm_type == "bilstm" and m.n_hidden == mods[0].n_hidden
                   for m in mods)

    def _gang_frame_predictors(self, mods, context, spks, out_lens, **kw):
        """Each predictor's x_hat, their BiLSTMs run as one multi-lane
        recurrence (one kernel launch forward, one backward). ``kw`` goes
        to each predictor's 'pre' phase."""
        pre = [m(context, s, out_lens, phase="pre", **kw)
               for m, s in zip(mods, spks)]
        ys = multi_bilstm_scan(
            torch.stack([p["conv"] for p in pre]), out_lens.mask,
            torch.stack([p["lstm"]["wi"] for p in pre]),
            torch.stack([p["lstm"]["wh"] for p in pre]),
            torch.stack([p["lstm"]["bias"] for p in pre]))
        return [m(None, None, out_lens, phase="post", lstm_out=ys[i])
                for i, m in enumerate(mods)]

    def _infer_frame_attrs(self, context, f0_spk, energy_spk, out_lens,
                           accent_vecs, f0_mean, f0_std):
        """(voiced_logits, f0, energy). The three predictors are
        independent given the context, so their six BiLSTM direction-lanes
        run in one recurrence launch."""
        mods = [self.voiced_predictor, self.f0_predictor,
                self.energy_predictor]
        if self._gangable(mods):
            hats = self._gang_frame_predictors(
                mods, context, [f0_spk, f0_spk, energy_spk], out_lens,
                accent_emb=accent_vecs)
            return (mods[0].inv_tx(hats[0]),
                    mods[1].inv_tx(hats[1], f0_mean, f0_std),
                    mods[2].inv_tx(hats[2]))
        voiced_logits = self.voiced_predictor.infer(
            context, f0_spk, out_lens, accent_emb=accent_vecs)
        f0 = self.f0_predictor.infer(context, f0_spk, out_lens, f0_mean,
                                     f0_std, accent_emb=accent_vecs)
        energy = self.energy_predictor.infer(context, energy_spk, out_lens,
                                             accent_emb=accent_vecs)
        return voiced_logits, f0, energy

    # ---- training forward -------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor], binarize: bool = False,
                train: bool = True,
                generator: Optional[torch.Generator] = None):
        """Training / validation forward. batch: text (B,Tt) int,
        input_lengths, mel (B,Tm,n_mel) unscaled, output_lengths,
        speaker_ids, accent_ids, f0 (B,Tm), voiced_mask, energy_avg,
        attn_prior (B,Tm,Tt), speaker_f0_mean/std. ``generator`` draws the
        dropout masks; ``train`` also updates the spectral norms' u. The
        predictors' outputs are {'x_hat', 'x'} dicts (prediction, target)."""
        c = self.config
        in_lens = SeqLens.create(batch["input_lengths"],
                                 batch["text"].shape[1])
        out_lens = SeqLens.create(batch["output_lengths"],
                                  batch["mel"].shape[1])
        mel = mel_scale(batch["mel"]) if c.scale_mel else batch["mel"]
        spk_vecs = self.speaker_embeddings(batch["speaker_ids"])
        accent_vecs = (self.accent_embeddings(batch["accent_ids"])
                       if c.use_accent else None)
        txt_enc, txt_emb = self.encode_text(batch["text"], in_lens,
                                            accent_vecs, train, generator)
        with train_span("train.align", mel.device):
            attn, attn_soft, _, attn_logprob = self.compute_attention(
                mel, txt_emb, spk_vecs, accent_vecs, out_lens, in_lens,
                batch.get("attn_prior"), binarize)
        context = torch.bmm(attn, txt_enc)                    # (B, Tm, C)

        outputs = self.decoder(mel, spk_vecs, context, out_lens,
                               f0=batch.get("f0"),
                               energy_avg=batch.get("energy_avg"),
                               accent_vecs=accent_vecs, train=train)
        outputs.update(attn=attn, attn_soft=attn_soft,
                       attn_logprob=attn_logprob, context=context,
                       spk_vecs=spk_vecs, accent_vecs=accent_vecs,
                       txt_enc=txt_enc)

        # the predictors train on detached inputs
        ctx_d, spk_d = context.detach(), spk_vecs.detach()
        acc_d = accent_vecs.detach() if accent_vecs is not None else None
        kw = dict(train=train, generator=generator)
        with train_span("train.attributes", ctx_d.device):
            frame_preds = []          # (output key, module, target)
            if self.f0_predictor is not None:
                frame_preds.append(("f0_outputs", self.f0_predictor,
                                    self.f0_predictor.targets(
                                        batch["f0"][..., None],
                                        batch.get("speaker_f0_mean"),
                                        batch.get("speaker_f0_std"))))
            if self.energy_predictor is not None:
                frame_preds.append(("energy_outputs", self.energy_predictor,
                                    self.energy_predictor.targets(
                                        batch["energy_avg"][..., None])))
            if self.voiced_predictor is not None:
                frame_preds.append(("voiced_outputs", self.voiced_predictor,
                                    self.voiced_predictor.targets(
                                        batch["voiced_mask"][..., None])))
            mods = [m for _, m, _ in frame_preds]
            if self._gangable(mods):
                hats = self._gang_frame_predictors(
                    mods, ctx_d, [spk_d] * len(mods), out_lens,
                    accent_emb=acc_d, **kw)
                for (key, _, target), x_hat in zip(frame_preds, hats):
                    outputs[key] = {"x_hat": x_hat, "x": target}
            else:
                for key, m, target in frame_preds:
                    outputs[key] = {"x_hat": m(ctx_d, spk_d, out_lens,
                                               accent_emb=acc_d, **kw),
                                    "x": target}
            if self.duration_predictor is not None:
                # (B, Tt, 1)
                dur_target = attn.detach().sum(dim=1)[..., None]
                outputs["duration_outputs"] = {
                    "x_hat": self.duration_predictor(
                        txt_enc.detach(), spk_d, in_lens, accent_emb=acc_d,
                        **kw),
                    "x": self.duration_predictor.targets(dur_target)}
        return outputs

    # ---- inference --------------------------------------------------------
    def infer_durations(self, text, text_lens, duration_speaker_ids,
                        accent_ids=None, token_duration_max: int = 100):
        """Stage A of two-stage serving: text -> encoder states, integer
        token durations and total frame counts (which pick the stage B
        frame bucket)."""
        c = self.config
        in_lens = SeqLens.create(text_lens, text.shape[1])
        dur_spk = self.speaker_embeddings(duration_speaker_ids)
        accent_vecs = (self.accent_embeddings(accent_ids)
                       if (c.use_accent and accent_ids is not None) else None)
        txt_enc, _ = self.encode_text(text, in_lens, accent_vecs)
        durations = self.duration_predictor.infer(
            txt_enc, dur_spk, in_lens, accent_emb=accent_vecs)[..., 0]
        durations = torch.clamp(torch.round(durations), 1, token_duration_max)
        durations = (durations * in_lens.fmask(durations.dtype)).to(
            torch.int32)
        return {"txt_enc": txt_enc, "durations": durations,
                "n_frames": durations.sum(-1)}

    def infer_decode(self, txt_enc, durations, speaker_ids,
                     decoder_speaker_ids=None, f0_speaker_ids=None,
                     energy_speaker_ids=None, accent_ids=None, f0_mean=None,
                     f0_std=None, sigma: float = 1.0, max_frames: int = 1024,
                     shift_stats: bool = True,
                     generator: Optional[torch.Generator] = None,
                     residual: Optional[torch.Tensor] = None):
        """Stage B of two-stage serving: encoder states + durations -> mel
        at the frame bucket ``max_frames``. The flow latent comes from
        ``generator`` unless ``residual`` is given."""
        c = self.config
        emb = self.speaker_embeddings
        dec_spk = emb(speaker_ids if decoder_speaker_ids is None
                      else decoder_speaker_ids)
        f0_spk = emb(speaker_ids if f0_speaker_ids is None
                     else f0_speaker_ids)
        energy_spk = emb(speaker_ids if energy_speaker_ids is None
                         else energy_speaker_ids)
        accent_vecs = (self.accent_embeddings(accent_ids)
                       if (c.use_accent and accent_ids is not None) else None)

        context, out_len_vals = regulate_length(txt_enc, durations,
                                                max_frames)
        out_lens = SeqLens.create(torch.clamp(out_len_vals, max=max_frames),
                                  max_frames)

        voiced_logits, f0_raw, energy = self._infer_frame_attrs(
            context, f0_spk, energy_spk, out_lens, accent_vecs, f0_mean,
            f0_std)
        voiced = torch.sigmoid(voiced_logits) > 0.5
        f0 = f0_raw * voiced

        if shift_stats and f0_mean is not None:
            # batch-global voiced stats, as in the JAX package
            vm = (voiced & out_lens.mask[..., None]).to(f0.dtype)
            n = vm.sum().clamp_min(1.0)
            mu = (f0 * vm).sum() / n
            var = ((f0 - mu) ** 2 * vm).sum() / n
            f0n = (f0 - mu) / torch.sqrt(var.clamp_min(1e-8))
            f0_shifted = (f0n * f0_std[:, None, None]
                          + f0_mean[:, None, None])
            f0 = torch.where(vm > 0, f0_shifted, f0)

        dec_out = self.decoder.infer(
            dec_spk, txt_enc, sigma, dur=durations, f0=f0[..., 0],
            energy_avg=energy[..., 0], lens=out_lens,
            accent_vecs=accent_vecs, residual=residual, generator=generator)
        mel = mel_descale(dec_out["mel"]) if c.scale_mel else dec_out["mel"]
        return {"mel": mel, "lens": out_lens, "durations": durations,
                "f0": f0, "energy": energy, "voiced": voiced}

    def infer(self, text, text_lens, speaker_ids, decoder_speaker_ids=None,
              f0_speaker_ids=None, energy_speaker_ids=None,
              duration_speaker_ids=None, accent_ids=None, f0_mean=None,
              f0_std=None, sigma: float = 1.0, max_frames: int = 1024,
              shift_stats: bool = True, token_duration_max: int = 100,
              generator: Optional[torch.Generator] = None,
              residual: Optional[torch.Tensor] = None):
        """Full sampling: infer_durations + infer_decode at one
        max_frames. Returns the infer_decode dict (mel descaled)."""
        d = self.infer_durations(
            text, text_lens,
            speaker_ids if duration_speaker_ids is None
            else duration_speaker_ids,
            accent_ids=accent_ids, token_duration_max=token_duration_max)
        return self.infer_decode(
            d["txt_enc"], d["durations"], speaker_ids,
            decoder_speaker_ids=decoder_speaker_ids,
            f0_speaker_ids=f0_speaker_ids,
            energy_speaker_ids=energy_speaker_ids, accent_ids=accent_ids,
            f0_mean=f0_mean, f0_std=f0_std, sigma=sigma,
            max_frames=max_frames, shift_stats=shift_stats,
            generator=generator, residual=residual)

    def reconstruct(self, batch: Dict[str, torch.Tensor], sigma: float = 1.0,
                    generator: Optional[torch.Generator] = None,
                    residual: Optional[torch.Tensor] = None):
        """Reconstruction (voice cloning) from a featurized batch: token
        durations from the hard MAS alignment of the batch's own mel, then
        the flow sampled on the batch's ground-truth F0 and energy. Returns
        {'mel' (descaled), 'attn', 'attn_soft', 'durations', 'lens'}."""
        c = self.config
        in_lens = SeqLens.create(batch["input_lengths"],
                                 batch["text"].shape[1])
        out_lens = SeqLens.create(batch["output_lengths"],
                                  batch["mel"].shape[1])
        mel = mel_scale(batch["mel"]) if c.scale_mel else batch["mel"]
        spk_vecs = self.speaker_embeddings(batch["speaker_ids"])
        accent_vecs = (self.accent_embeddings(batch["accent_ids"])
                       if c.use_accent else None)
        txt_enc, txt_emb = self.encode_text(batch["text"], in_lens,
                                            accent_vecs)
        attn, attn_soft, _, _ = self.compute_attention(
            mel, txt_emb, spk_vecs, accent_vecs, out_lens, in_lens,
            batch.get("attn_prior"), binarize=True)
        durations = attn.sum(dim=1).to(torch.int32)          # (B, T_text)
        dec_out = self.decoder.infer(
            spk_vecs, txt_enc, sigma, dur=durations, f0=batch.get("f0"),
            energy_avg=batch.get("energy_avg"), lens=out_lens,
            accent_vecs=accent_vecs, residual=residual, generator=generator)
        out_mel = (mel_descale(dec_out["mel"]) if c.scale_mel
                   else dec_out["mel"])
        return {"mel": out_mel, "attn": attn, "attn_soft": attn_soft,
                "durations": durations, "lens": out_lens}
