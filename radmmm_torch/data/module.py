"""Data module: builds text processing, datasets, loaders for fit/predict.

Counterpart of ``radmmm_tpu/data/module.py``, the reference's
BaseAudioDataModule (data_modules.py:40-156): constructs
TextProcessing from config, derives speaker/accent id maps from the
*training* dataset (data_modules.py:104-110 — predict without the training
filelists requires pinning `speaker_ids`), and exposes
train/val/predict loaders.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

from radmmm_torch.data.collate import Featurizer
from radmmm_torch.data.dataset import AudioDataset, TextOnlyData
from radmmm_torch.data.loader import DataLoader
from radmmm_torch.text.processing import TextProcessing


class AudioDataModule:
    def __init__(self, train_config: Dict[str, Any],
                 val_config: Optional[Dict[str, Any]] = None,
                 batch_size: int = 8,
                 symbol_set: str = "radmmm_phonemizer_marker_segregated",
                 cleaner_names=("basic_cleaners",),
                 heteronyms_path: Optional[str] = None,
                 phoneme_dict_path: Optional[str] = None,
                 p_phoneme: float = 1.0, handle_phoneme: str = "word",
                 handle_phoneme_ambiguous: str = "ignore",
                 prepend_space_to_text: bool = True,
                 append_space_to_text: bool = True,
                 add_bos_eos_to_text: bool = False,
                 g2p_type: str = "phonemizer",
                 phonemizer_cfg: Optional[Dict[str, str]] = None,
                 inference_transcript: Optional[str] = None,
                 dataset_kwargs: Optional[Dict[str, Any]] = None,
                 featurizer_kwargs: Optional[Dict[str, Any]] = None,
                 num_threads: int = 4, seed: int = 0,
                 device: str = "cuda"):
        self.tp = TextProcessing(
            symbol_set, list(cleaner_names), heteronyms_path,
            phoneme_dict_path, p_phoneme=p_phoneme,
            handle_phoneme=handle_phoneme,
            handle_phoneme_ambiguous=handle_phoneme_ambiguous,
            prepend_space_to_text=prepend_space_to_text,
            append_space_to_text=append_space_to_text,
            add_bos_eos_to_text=add_bos_eos_to_text,
            g2p_type=g2p_type, phonemizer_cfg=phonemizer_cfg)
        self.batch_size = batch_size
        self.num_threads = num_threads
        self.seed = seed
        self.train_config = train_config
        self.val_config = val_config
        self.inference_transcript = inference_transcript
        self.dataset_kwargs = dict(dataset_kwargs or {})
        fk = dict(featurizer_kwargs or {})
        fk.setdefault("seed", seed)
        fk.setdefault("device", device)
        self.featurizer = Featurizer(**fk)
        self.trainset = None
        self.valset = None
        self.predictset = None

    @property
    def n_text_tokens(self) -> int:
        return len(self.tp.symbols)

    def setup(self, stage: str = "fit"):
        self.trainset = AudioDataset(self.train_config, self.tp,
                                     dataloader_type="train",
                                     seed=self.seed, **self.dataset_kwargs)
        if stage == "fit":
            if self.val_config is not None:
                val_kwargs = dict(self.dataset_kwargs)
                val_kwargs.pop("use_wave_augmentations", None)
                self.valset = AudioDataset(
                    self.val_config, self.tp, dataloader_type="val",
                    speaker_ids=self.trainset.speaker_ids,
                    accent_ids=self.trainset.accent_ids,
                    seed=self.seed, **val_kwargs)
        elif stage == "predict":
            # id maps come from the training filelists (data_modules.py:117-127)
            self.predictset = TextOnlyData(
                self.inference_transcript, self.tp,
                self.trainset.speaker_ids, self.trainset.accent_ids,
                speaker_stats_path=self.dataset_kwargs.get(
                    "speaker_stats_path"),
                f0_pred_type=self.dataset_kwargs.get("f0_pred_type",
                                                     "norm_log_f0"))

    def train_dataloader(self) -> DataLoader:
        return DataLoader(self.trainset, self.batch_size, shuffle=True,
                          featurizer=self.featurizer,
                          num_threads=self.num_threads, seed=self.seed,
                          hop_length=self.featurizer.hop_length)

    def val_dataloader(self) -> DataLoader:
        return DataLoader(self.valset, self.batch_size, shuffle=False,
                          featurizer=self.featurizer,
                          num_threads=self.num_threads,
                          hop_length=self.featurizer.hop_length,
                          uniform_shape=True)

    def predict_items(self):
        for i in range(len(self.predictset)):
            yield self.predictset[i]
