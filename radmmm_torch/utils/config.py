"""Config system: multi-file YAML composition + dotted overrides +
reference-config translation.

Mirrors the reference's LightningCLI conventions (tts_main.py:36-68):
several `-c` files merged in order (later wins), `class_path`/`init_args`
component injection, and CLI dotted overrides (`--model.learning_rate=1e-4`,
the jsonargparse idiom + the legacy update_params of common.py:84-102).

`translate_reference_model_config` maps the reference's class paths
(decoders.RADMMMFlow, loss.RADMMMLoss, attribute_predictors.ConvLSTMLinearDAP,
common.Encoder, loss.*RegLoss) onto this framework's declarative configs, so
the shipped RADMMM yamls drive the port unchanged. A copy owned by the
port of radmmm_tpu/utils/config.py.
"""
from __future__ import annotations

import ast
import copy
from typing import Any, Dict, List, Optional, Sequence

import yaml


def deep_merge(base: Dict[str, Any], override: Dict[str, Any]) -> Dict[str, Any]:
    out = copy.deepcopy(base)
    for k, v in override.items():
        if (k in out and isinstance(out[k], dict) and isinstance(v, dict)):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def load_configs(paths: Sequence[str]) -> Dict[str, Any]:
    cfg: Dict[str, Any] = {}
    for p in paths:
        with open(p) as f:
            cfg = deep_merge(cfg, yaml.safe_load(f) or {})
    return cfg


def apply_overrides(cfg: Dict[str, Any],
                    overrides: Sequence[str]) -> Dict[str, Any]:
    """--a.b.c=value dotted assignments with literal-eval values."""
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        ov = ov.lstrip("-")
        key, _, raw = ov.partition("=")
        try:
            value = ast.literal_eval(raw)
        except (ValueError, SyntaxError):
            value = raw
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return cfg


def _init_args(section: Optional[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    if section is None:
        return None
    if "init_args" in section or "class_path" in section:
        return copy.deepcopy(section.get("init_args", {}))
    return copy.deepcopy(section)


def _class_name(section: Optional[Dict[str, Any]]) -> Optional[str]:
    if section is None:
        return None
    cp = section.get("class_path")
    return cp.rsplit(".", 1)[-1] if cp else None


def translate_reference_model_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """reference `model:` section -> kwargs for TTSConfig / LossConfig /
    optimizer / trainer-phase settings."""
    m = cfg.get("model", cfg)

    decoder_args = _init_args(m.get("decoder")) or {}
    decoder_args.pop("unvoiced_bias_activation", None)

    predictors = {}
    for name in ("f0_predictor", "energy_predictor", "voiced_predictor",
                 "duration_predictor"):
        args = _init_args(m.get(name))
        if args is not None:
            cls = _class_name(m.get(name))
            if cls and cls != "ConvLSTMLinearDAP":
                args["_class"] = cls
        predictors[name] = args

    encoder_args = _init_args(m.get("text_encoder")) or {}

    tts_kwargs: Dict[str, Any] = dict(
        n_text_tokens=m.get("n_text_tokens", 426),
        n_text_dim=m.get("n_text_dim", 512),
        n_speakers=m.get("n_speakers", 1),
        n_speaker_dim=m.get("n_speaker_dim", 16),
        n_augmentations=m.get("n_augmentations", 0),
        use_accent=m.get("use_accent", False),
        n_accents=m.get("n_accents", 0),
        n_accent_dim=m.get("n_accent_dim", 0),
        n_mel_channels=m.get("n_mel_channels", 80),
        use_accent_emb_for_encoder=m.get("use_accent_emb_for_encoder",
                                         False),
        use_accent_emb_for_decoder=m.get("use_accent_emb_for_decoder",
                                         False),
        use_accent_emb_for_alignment=m.get("use_accent_emb_for_alignment",
                                           False),
        use_speaker_emb_for_alignment=m.get("use_speaker_emb_for_alignment",
                                            False),
        encoder_n_convolutions=encoder_args.get("encoder_n_convolutions", 3),
        encoder_kernel_size=encoder_args.get("encoder_kernel_size", 5),
        lstm_norm_fn=encoder_args.get("lstm_norm_fn",
                                      m.get("lstm_norm_fn", "spectral")),
        scale_mel=m.get("scale_mel", True),
        f0_loss_voiced_only=m.get("f0_loss_voiced_only", True),
        decoder=decoder_args,
        **predictors,
    )

    loss_args = _init_args(m.get("decoder_loss")) or {}
    loss_kwargs: Dict[str, Any] = dict(
        sigma=loss_args.get("sigma", m.get("sigma", 1.0)),
        n_group_size=loss_args.get("n_group_size",
                                   decoder_args.get("n_group_size", 1)),
        ctc_blank_logprob=loss_args.get("CTC_blank_logprob", -1),
        kl_loss_start_iter=loss_args.get("kl_loss_start_iter", 5000),
        binarization_loss_weight=loss_args.get("binarization_loss_weight",
                                               1.0),
        ctc_loss_weight=loss_args.get("ctc_loss_weight", 0.1),
        binarization_start_iter=m.get("binarization_start_iter", 0),
        f0_loss_voiced_only=m.get("f0_loss_voiced_only", True),
    )
    # per-predictor loss class + weight (the shipped vpred config uses
    # AttributeRegressionLoss on logits rather than BCE — honor it)
    for name, key in (("f0", "f0_predictor_loss"),
                      ("energy", "energy_predictor_loss"),
                      ("vpred", "voiced_predictor_loss"),
                      ("duration", "duration_predictor_loss")):
        section = m.get(key)
        if section is not None:
            largs = _init_args(section) or {}
            loss_kwargs[f"{name}_weight"] = largs.get("weight", 1.0)
            cls = _class_name(section)
            if cls:
                loss_kwargs[f"{name}_loss_type"] = (
                    "bce" if "BCE" in cls else "regression")

    spk_reg = _init_args(m.get("speaker_embed_regularization_loss"))
    if spk_reg:
        loss_kwargs["speaker_reg"] = {
            "variance": spk_reg.get("loss_variance_weight", 0.0),
            "covariance": spk_reg.get("loss_covariance_weight", 0.0)}
    acc_reg = _init_args(m.get("accent_embed_regularization_loss"))
    if acc_reg:
        loss_kwargs["accent_reg"] = {
            "variance": acc_reg.get("loss_variance_weight", 0.0),
            "covariance": acc_reg.get("loss_covariance_weight", 0.0)}
    cross = _init_args(m.get("speaker_accent_cross_regularization_loss"))
    if cross:
        loss_kwargs["cross_covariance_weight"] = cross.get(
            "loss_cross_covariance_weight", 0.0)

    optim_kwargs = dict(
        optim_algo=m.get("optim_algo", "RAdam"),
        learning_rate=m.get("learning_rate", 1e-4),
        weight_decay=m.get("weight_decay", 1e-6),
        grad_clip_val=cfg.get("trainer", {}).get("gradient_clip_val", 1.0),
    )

    run_kwargs = dict(
        output_directory=m.get("output_directory", "./output"),
        iters_per_checkpoint=m.get("iters_per_checkpoint", 3000),
        binarization_start_iter=m.get("binarization_start_iter", 0),
        seed=m.get("seed") or cfg.get("seed_everything", 42),
        vocoder_type=m.get("vocoder_type", "hifigan"),
        vocoder_config_path=m.get("vocoder_config_path"),
        vocoder_checkpoint_path=m.get("vocoder_checkpoint_path"),
        sampling_rate=m.get("sampling_rate", 22050),
        decoder_path=m.get("decoder_path"),
        encoders_path=m.get("encoders_path"),
        use_syncbnorm=m.get("use_syncbnorm", False),
        prediction_output_dir=m.get("prediction_output_dir"),
        predict_mode=m.get("predict_mode", "tts"),
    )
    return {"tts": tts_kwargs, "loss": loss_kwargs, "optim": optim_kwargs,
            "run": run_kwargs}


def translate_reference_data_config(cfg: Dict[str, Any]) -> Dict[str, Any]:
    """reference `data:` section -> AudioDataModule kwargs."""
    d = cfg.get("data", cfg)
    init = d.get("init_args", d)
    dataset_kwargs = dict(
        sampling_rate=init.get("sampling_rate", 22050),
        max_wav_value=init.get("max_wav_value", 32768.0),
        dur_min=init.get("dur_min"), dur_max=init.get("dur_max"),
        use_multilingual_model=init.get("use_multilingual_model", True),
        combine_speaker_and_emotion=init.get("combine_speaker_and_emotion",
                                             False),
        use_wave_augmentations=init.get("use_wave_augmentations", False),
        wave_aug_config=init.get("wave_aug_config"),
        speaker_stats_path=init.get("speaker_stats_path"),
        f0_pred_type=init.get("f0_pred_type", "norm_log_f0"),
        include_speakers=init.get("include_speakers"),
        include_emotions=init.get("include_emotions"),
        speaker_map=init.get("speaker_map"),
        audio_cache_path=init.get("lmdb_cache_path"),
        f0_cache_path=init.get("f0_cache_path"),
    )
    featurizer_kwargs = dict(
        filter_length=init.get("filter_length", 1024),
        hop_length=init.get("hop_length", 256),
        win_length=init.get("win_length", 1024),
        n_mel_channels=init.get("n_mel_channels", 80),
        sampling_rate=init.get("sampling_rate", 22050),
        mel_fmin=init.get("mel_fmin", 0.0),
        mel_fmax=init.get("mel_fmax"),
        f0_min=init.get("f0_min", 80.0), f0_max=init.get("f0_max", 640.0),
        use_log_f0=bool(init.get("use_log_f0", True)),
        use_scaled_energy=bool(init.get("use_scaled_energy", True)),
        use_attn_prior_masking=bool(init.get("use_attn_prior_masking",
                                             True)),
        betabinom_scaling_factor=init.get("betabinom_scaling_factor", 0.05),
        mel_noise_scale=init.get("mel_noise_scale", 0.0),
        distance_tx_unvoiced=bool(init.get("distance_tx_unvoiced", False)),
        f0_method=init.get("f0_method", "pyin"),
    )
    def datasets_of(*keys):
        for k in keys:
            if k in init and init[k]:
                v = init[k]
                return v.get("datasets", v) if isinstance(v, dict) else v
        return None

    # a `dataset_recipe:` JSON (datasets/22khz-*.json) expands into the
    # train/val dataset dicts when no explicit filelist sections are given
    # (radmmm_torch/data/recipes.py)
    train_config = datasets_of("training_files", "trainset_config")
    val_config = datasets_of("validation_files", "valset_config")
    recipe = init.get("dataset_recipe")
    if recipe:
        from radmmm_torch.data.recipes import recipe_dataset_configs
        root = init.get("dataset_recipe_audio_root")
        fbd = init.get("dataset_recipe_filelist_basedir", "datasets/")
        if not train_config:
            train_config = recipe_dataset_configs(
                recipe, "train", audio_root=root, filelist_basedir=fbd)
        if not val_config:
            val_config = recipe_dataset_configs(
                recipe, "val", audio_root=root, filelist_basedir=fbd)

    return dict(
        train_config=train_config or {},
        val_config=val_config,
        batch_size=init.get("batchsize", init.get("batch_size", 8)),
        symbol_set=init.get("symbol_set",
                            "radmmm_phonemizer_marker_segregated"),
        cleaner_names=init.get("cleaners",
                               init.get("cleaner_names",
                                        ["basic_cleaners"])),
        heteronyms_path=init.get("heteronyms_path"),
        phoneme_dict_path=init.get("phoneme_dict_path"),
        p_phoneme=init.get("p_phoneme", 1.0),
        handle_phoneme=init.get("handle_phoneme", "word"),
        handle_phoneme_ambiguous=init.get("handle_phoneme_ambiguous",
                                          "ignore"),
        prepend_space_to_text=bool(init.get("prepend_space_to_text", True)),
        append_space_to_text=bool(init.get("append_space_to_text", True)),
        add_bos_eos_to_text=bool(init.get("add_bos_eos_to_text", False)),
        g2p_type=init.get("g2p_type", "phonemizer"),
        phonemizer_cfg=init.get("phonemizer_cfg"),
        inference_transcript=init.get("inference_transcript"),
        num_threads=init.get("num_workers", 4),
        dataset_kwargs=dataset_kwargs,
        featurizer_kwargs=featurizer_kwargs,
    )
