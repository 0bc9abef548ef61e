"""Dataset + datamodule for beat tracking training, torch-free.

Behavioural equivalent of the reference BeatTrackingDataset / BeatDataModule
(beat_this/dataset/dataset.py) on the same on-disk layout:

    data_dir/annotations/<dataset>/info.json
    data_dir/annotations/<dataset>/<single|8-folds>.split       (TSV)
    data_dir/annotations/<dataset>/annotations/beats/<piece>.beats
    data_dir/audio/spectrograms/<dataset>.npz                   (bundled)
    data_dir/audio/spectrograms/<dataset>/<piece>/track*.npy    (fallback)

TPU-first input pipeline: items are sampled and assembled with numpy into
fixed-shape batches of (accum_steps, microbatch, 1500, 128) fed straight to
the jitted SPMD train step; a thread-pool prefetcher overlaps host assembly
with device steps (replacing torch DataLoader worker processes). All
randomness is an explicit, seedable numpy Generator.

The port's copy of beat_this_tpu/data/dataset.py, kept so that the port imports nothing of
the JAX package; the tests hold the two to identical results.
"""

from __future__ import annotations

import json
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from beat_this_tpu_torch.data.augment import (
    augment_mask_,
    augment_pitchtempo,
    precomputed_augmentation_filenames,
)
from beat_this_tpu_torch.data.mmnpz import MemmappedNpz
from beat_this_tpu_torch.utils import index_to_framewise


class BeatTrackingDataset:
    """Map-style dataset over `dataset/piece` items.

    Args mirror the reference (beat_this/dataset/dataset.py:23-79).
    """

    def __init__(
        self,
        item_names,
        data_folder,
        spect_fps=50,
        train_length=1500,
        deterministic=False,
        augmentations=None,
        length_based_oversampling_factor=0,
        seed=0,
    ):
        data_folder = Path(data_folder)
        self.spect_basepath = data_folder / "audio" / "spectrograms"
        self.annotation_basepath = data_folder / "annotations"
        self.fps = spect_fps
        self.train_length = train_length
        self.deterministic = deterministic
        self.augmentations = augmentations or {}
        self.length_based_oversampling_factor = length_based_oversampling_factor
        self.rng = np.random.default_rng(seed)
        datasets = sorted(set(name.split("/", 1)[0] for name in item_names))
        self.dataset_info = {
            d: json.loads((self.annotation_basepath / d / "info.json").read_text())
            for d in datasets
        }
        self.spects = {}
        for d in datasets:
            npz_file = (self.spect_basepath / d).with_suffix(".npz")
            if npz_file.exists():
                self.spects[d] = MemmappedNpz(npz_file)
        with ThreadPoolExecutor() as executor:
            items = executor.map(self._load_dataset_item, item_names)
        items = [item for item in items if item is not None]
        if self.length_based_oversampling_factor and self.train_length is not None:
            oversampled = []
            for item in items:
                factor = int(
                    np.round(
                        self.length_based_oversampling_factor
                        * len(self._get_spect(item))
                        / self.train_length
                    )
                )
                oversampled.extend([item] * max(factor, 1))
            print(
                f"Length-based oversampling: {len(items)} -> "
                f"{len(oversampled)} training excerpts."
            )
            items = oversampled
        self.items = items

    def _load_dataset_item(self, item_name):
        dataset, stem = item_name.split("/", 1)
        # require every augmented spectrogram variant to exist
        for aug_filename in precomputed_augmentation_filenames(self.augmentations):
            key = f"{stem}/{aug_filename[:-4]}"
            in_bundle = dataset in self.spects and key in self.spects[dataset]
            on_disk = (self.spect_basepath / item_name / aug_filename).exists()
            if not in_bundle and not on_disk:
                print(
                    f"Dropping {item_name}: missing at least one of its "
                    "precomputed augmented spectrograms."
                )
                return None
        annotation_path = (
            self.annotation_basepath / dataset / "annotations" / "beats"
            / (stem + ".beats")
        )
        beat_annotation = np.loadtxt(annotation_path, ndmin=0)
        if beat_annotation.ndim == 2:
            beat_time = beat_annotation[:, 0]
            beat_value = beat_annotation[:, 1].astype(int)
        else:
            beat_time = np.atleast_1d(beat_annotation)
            beat_value = np.zeros_like(beat_time, dtype=np.int32)
        if self.dataset_info[dataset]["has_downbeats"] and beat_annotation.ndim != 2:
            print(
                f"Dropping {item_name}: the dataset promises downbeat "
                f"annotations but the beats file is {beat_annotation.ndim}-"
                "dimensional instead of 2-column."
            )
            return None
        downbeat_mask = bool(self.dataset_info[dataset]["has_downbeats"])
        display_dataset = dataset
        if dataset == "rwc":
            display_dataset = "rwc_" + stem.split("_", 2)[1]
        return {
            "spect_path": f"{item_name}/track.npy",
            "beat_time": beat_time,
            "beat_value": beat_value,
            "downbeat_mask": downbeat_mask,
            "dataset": display_dataset,
        }

    def _get_spect(self, item):
        dataset, filename = str(item["spect_path"]).split("/", 1)
        if dataset in self.spects and filename[:-4] in self.spects[dataset]:
            return self.spects[dataset][filename[:-4]]
        return np.load(self.spect_basepath / item["spect_path"], mmap_mode="r")

    def get_frame_count(self, index):
        return len(self._get_spect(self.items[index]))

    def get_beat_count(self, index):
        return len(self.items[index]["beat_time"])

    def get_downbeat_count(self, index):
        return int((self.items[index]["beat_value"] == 1).sum())

    def __len__(self):
        return len(self.items)

    def __getitem__(self, index):
        return self.fetch(index)

    def fetch(self, index, rng=None):
        """Assemble one training/eval example. `rng` (a numpy Generator)
        drives the augmentation choice, crop position and mask augmentation;
        passing explicit per-item generators makes parallel batch assembly
        deterministic regardless of thread scheduling
        (BeatDataModule.train_batches)."""
        if rng is None:
            rng = self.rng
        item = self.items[index]
        item = augment_pitchtempo(item, self.augmentations, rng)
        spect = self._get_spect(item)
        original_length = len(spect)
        if self.train_length is not None:
            longer = original_length - self.train_length
        else:
            longer = 0
        if longer > 0:
            if self.deterministic:
                start_frame = longer // 2
            else:
                start_frame = int(rng.integers(0, longer))
            end_frame = start_frame + self.train_length
        else:
            start_frame, end_frame = 0, original_length
        spect = np.array(spect[start_frame:end_frame], dtype=np.float32)
        if "mask" in self.augmentations:
            augment_mask_(spect, self.augmentations, self.fps, rng)
        (
            truth_beat,
            truth_downbeat,
            truth_orig_beat,
            truth_orig_downbeat,
        ) = prepare_annotations(item, start_frame, end_frame, self.fps)
        out_length = (
            self.train_length if self.train_length is not None else original_length
        )
        padding_mask = np.ones(out_length, dtype=bool)
        if longer < 0:
            spect = np.pad(spect, [(0, -longer), (0, 0)])
            truth_beat = np.pad(truth_beat, (0, -longer))
            truth_downbeat = np.pad(truth_downbeat, (0, -longer))
            padding_mask[longer:] = False
        return {
            "spect": spect,
            "spect_path": str(item["spect_path"]),
            "dataset": item["dataset"],
            "start_frame": start_frame,
            "truth_beat": truth_beat,
            "truth_downbeat": truth_downbeat,
            "downbeat_mask": item["downbeat_mask"],
            "padding_mask": padding_mask,
            "truth_orig_beat": truth_orig_beat,
            "truth_orig_downbeat": truth_orig_downbeat,
        }


def prepare_annotations(item, start_frame, end_frame, fps):
    """Quantized framewise targets + unquantized original times for the
    excerpt (reference beat_this/dataset/dataset.py:512-556). The original
    times are returned as float64 arrays (the reference serializes them with
    .tobytes() only to survive torch collation)."""
    truth_bdb_time = item["beat_time"]
    truth_bdb_value = item["beat_value"]
    truth_bdb_frame = np.round(truth_bdb_time * fps).astype(int) - start_frame
    lo = np.searchsorted(truth_bdb_frame, 0)
    hi = np.searchsorted(truth_bdb_frame, end_frame - start_frame)
    frames = truth_bdb_frame[lo:hi]
    values = truth_bdb_value[lo:hi]
    length = end_frame - start_frame
    framewise_beat = index_to_framewise(frames, length)
    framewise_downbeat = index_to_framewise(frames[values == 1], length)
    start_t, end_t = start_frame / fps, end_frame / fps
    orig_beat = truth_bdb_time
    orig_downbeat = truth_bdb_time[item["beat_value"] == 1]
    orig_beat = orig_beat[(orig_beat >= start_t) & (orig_beat < end_t)] - start_t
    orig_downbeat = (
        orig_downbeat[(orig_downbeat >= start_t) & (orig_downbeat < end_t)] - start_t
    )
    return framewise_beat, framewise_downbeat, orig_beat, orig_downbeat


def collate(items: list[dict]) -> dict:
    """Stack fixed-shape fields; keep ragged/string fields as lists."""
    batch = {}
    for key in items[0]:
        vals = [it[key] for it in items]
        if key in ("spect", "truth_beat", "truth_downbeat", "padding_mask"):
            batch[key] = np.stack(vals)
        elif key in ("downbeat_mask",):
            batch[key] = np.asarray(vals)
        else:
            batch[key] = vals
    return batch


class BeatDataModule:
    """Split handling + batch iterators (reference BeatDataModule,
    beat_this/dataset/dataset.py:247-509)."""

    def __init__(
        self,
        data_dir,
        batch_size=8,
        train_length=1500,
        num_workers=8,
        augmentations=None,
        test_dataset="gtzan",
        hung_data=False,
        no_val=False,
        spect_fps=50,
        length_based_oversampling_factor=0,
        fold=None,
        predict_datasplit="test",
        seed=0,
    ):
        if augmentations is None:
            augmentations = {
                "pitch": {"min": -5, "max": 6},
                "tempo": {"min": -20, "max": 20, "stride": 4},
            }
        if not set(augmentations.keys()).issubset({"mask", "pitch", "tempo"}):
            raise ValueError(f"Unsupported augmentations: {augmentations.keys()}")
        self.data_dir = Path(data_dir)
        self.batch_size = batch_size
        self.train_length = train_length
        self.num_workers = num_workers
        self.augmentations = augmentations
        self.test_set_name = test_dataset
        self.hung_data = hung_data
        self.no_val = no_val
        self.spect_fps = spect_fps
        self.length_based_oversampling_factor = length_based_oversampling_factor
        self.fold = fold
        self.predict_datasplit = predict_datasplit
        self.seed = seed
        self.initialized = {}

    def hparams(self) -> dict:
        """Hyperparameters embedded into checkpoints (role of Lightning's
        save_hyperparameters, reference dataset.py:287)."""
        return {
            "batch_size": self.batch_size,
            "train_length": self.train_length,
            "num_workers": self.num_workers,
            "augmentations": self.augmentations,
            "test_dataset": self.test_set_name,
            "hung_data": self.hung_data,
            "no_val": self.no_val,
            "spect_fps": self.spect_fps,
            "length_based_oversampling_factor": self.length_based_oversampling_factor,
            "fold": self.fold,
            "predict_datasplit": self.predict_datasplit,
        }

    def _read_split(self, path):
        rows = []
        for line in Path(path).read_text().splitlines():
            if line.strip():
                piece, part = line.split("\t")
                rows.append((piece, part))
        return rows

    # Datasets used in the "hung" comparability subset (MODELING BEATS AND
    # DOWNBEATS WITH A TIME-FREQUENCY TRANSFORMER); the trailing empty
    # alternative deliberately matches dataset-less items, as the reference
    # regex does (reference dataset.py:352-360).
    _HUNG_PREFIXES = (
        "hainsworth/", "ballroom/", "hjdb/", "beatles/", "rwc/rwc_popular",
        "simac/", "smc/", "harmonix/", "",
    )

    def _collect_fit_items(self):
        """Bucket every annotated piece (outside the test set) into its
        train/val role according to the active split scheme.

        Behavioral contract: reference dataset.py:312-370 — 8-fold CV when a
        fold index is set (that fold validates, the rest train), otherwise the
        per-dataset "single.split" role column; `no_val` folds the validation
        pieces back into training; `hung_data` restricts training to a fixed
        dataset subset.
        """
        split_name = "8-folds.split" if self.fold is not None else "single.split"
        buckets = {"train": [], "val": []}
        for split_path in sorted(self.data_dir.glob(f"annotations/*/{split_name}")):
            corpus = split_path.parent.name
            if corpus == self.test_set_name:
                continue
            for piece, part in self._read_split(split_path):
                if self.fold is not None:
                    role = "val" if int(part) == self.fold else "train"
                else:
                    role = part if part in buckets else None
                if role is not None:
                    buckets[role].append(f"{corpus}/{piece}")
        if self.no_val:
            buckets["train"] += buckets["val"]
        if self.hung_data:
            buckets["train"] = [
                item for item in buckets["train"]
                if item.startswith(self._HUNG_PREFIXES)
            ]
        return sorted(buckets["train"]), sorted(buckets["val"])

    def _make_eval_dataset(self, items, full_pieces=False):
        """A deterministic, augmentation-free dataset over `items`."""
        return BeatTrackingDataset(
            items,
            deterministic=True,
            augmentations={},
            train_length=None if full_pieces else self.train_length,
            data_folder=self.data_dir,
            spect_fps=self.spect_fps,
        )

    @staticmethod
    def _announce(label, items, sources):
        print(f"{label}:", len(items), "items from:", *sources)

    def setup(self, stage):
        if self.initialized.get(stage, False):
            return

        if stage in ("fit", "validate"):
            self.train_items, self.val_items = self._collect_fit_items()
            self.val_dataset = self._make_eval_dataset(self.val_items)
            self._announce(
                "Validation set", self.val_items,
                sorted({i.split("/", 1)[0] for i in self.val_items}),
            )
            self.initialized["validate"] = True

        if stage == "fit":
            self.train_dataset = BeatTrackingDataset(
                self.train_items,
                deterministic=False,
                augmentations=self.augmentations,
                train_length=self.train_length,
                data_folder=self.data_dir,
                spect_fps=self.spect_fps,
                length_based_oversampling_factor=self.length_based_oversampling_factor,
                seed=self.seed,
            )
            self._announce(
                "Training set", self.train_items,
                sorted({i.split("/", 1)[0] for i in self.train_items}),
            )
            self.initialized["fit"] = True

        if stage == "test":
            beats_dir = (
                self.data_dir / "annotations" / self.test_set_name
                / "annotations" / "beats"
            )
            self.test_items = sorted(
                f"{self.test_set_name}/{f.stem}" for f in beats_dir.glob("*.beats")
            )
            self.test_dataset = self._make_eval_dataset(
                self.test_items, full_pieces=True
            )
            self._announce("Test set", self.test_items, [self.test_set_name])
            self.initialized["test"] = True

        if stage == "predict":
            if self.predict_datasplit == "test":
                self.setup("test")
                self.predict_dataset = self.test_dataset
            else:
                source_stage = "fit" if self.predict_datasplit == "train" else "validate"
                self.setup(source_stage)
                items = (
                    self.train_items if self.predict_datasplit == "train"
                    else self.val_items
                )
                self.predict_dataset = self._make_eval_dataset(
                    items, full_pieces=True
                )
            self.initialized["predict"] = True

    # -- iterators ---------------------------------------------------------
    def train_batches(self, accum_steps: int, seed: int = 0,
                      host_shard: tuple[int, int] = (0, 1)):
        """Infinite iterator of train batches shaped (accum, micro, ...),
        shuffled per epoch, drop-last (reference train loader:
        dataset.py:448-456).

        `host_shard=(process_index, process_count)`: in multi-host data
        parallelism every process derives the SAME global epoch order from
        `seed`, but materializes only its contiguous slice of each global
        batch's micro axis — micro size becomes batch_size / process_count
        and no host ever assembles the full global batch."""
        pid, n_hosts = host_shard
        if self.batch_size % n_hosts:
            raise ValueError(
                f"batch_size {self.batch_size} must divide evenly over "
                f"{n_hosts} processes"
            )
        local_bs = self.batch_size // n_hosts
        dataset = self.train_dataset
        rng = np.random.default_rng(seed)
        # independent stream for per-item randomness (crop position,
        # augmentation choice, masking): one spawned child generator per
        # GLOBAL batch slot, so (a) assembly can run on a thread pool with
        # deterministic results regardless of scheduling and (b) every host
        # of a multi-host run derives the same randomness for the same
        # global slot
        item_stream = np.random.default_rng([seed, 0x1517])
        per_step = self.batch_size * accum_steps
        if len(dataset) < per_step:
            raise ValueError(
                f"training set ({len(dataset)} items) is smaller than one "
                f"optimizer step ({per_step} = batch_size * accum_steps)"
            )
        local = slice(pid * local_bs, (pid + 1) * local_bs)
        with ThreadPoolExecutor(max_workers=max(self.num_workers, 1)) as pool:
            while True:
                order = rng.permutation(len(dataset))
                for i in range(0, len(order) - per_step + 1, per_step):
                    idx = order[i : i + per_step].reshape(
                        accum_steps, self.batch_size
                    )[:, local]
                    kids = np.empty((per_step,), object)
                    kids[:] = item_stream.spawn(per_step)
                    kids = kids.reshape(accum_steps, self.batch_size)[:, local]
                    items = list(
                        pool.map(dataset.fetch, idx.ravel(), kids.ravel())
                    )
                    batch = collate(items)
                    yield {
                        key: (
                            value.reshape(
                                (accum_steps, local_bs) + value.shape[1:]
                            )
                            if isinstance(value, np.ndarray)
                            else value
                        )
                        for key, value in batch.items()
                    }

    def steps_per_epoch(self, accum_steps: int) -> int:
        return len(self.train_dataset) // (self.batch_size * accum_steps)

    def val_batches(self):
        """Validation batches, every one padded to `batch_size` rows.

        A ragged final batch would retrace the jitted eval step on every
        run (its shape differs from the compiled bucket); instead the tail
        is zero-padded — spect zeros, padding_mask all-False, downbeat_mask
        0, so the padded rows contribute exactly nothing to any masked loss
        numerator — and the true row count rides along as `n_valid`. The
        consumer must restrict per-piece work to the first `n_valid` rows
        and may rescale mean-reduced losses by rows/n_valid (all losses in
        train/loss.py are means over batch elements, so the correction is
        exact; see Trainer.validate)."""
        dataset = self.val_dataset
        for i in range(0, len(dataset), self.batch_size):
            items = [
                dataset[j]
                for j in range(i, min(i + self.batch_size, len(dataset)))
            ]
            batch = collate(items)
            n_valid = len(items)
            if n_valid < self.batch_size:
                pad = self.batch_size - n_valid
                for key, value in batch.items():
                    if isinstance(value, np.ndarray):
                        batch[key] = np.concatenate(
                            [value, np.zeros((pad,) + value.shape[1:],
                                             value.dtype)]
                        )
            batch["n_valid"] = n_valid
            yield batch

    def predict_pieces(self):
        """Full pieces one by one (reference predict loader bs=1)."""
        dataset = self.predict_dataset
        for i in range(len(dataset)):
            yield dataset[i]

    def get_train_positive_weights(self, widen_target_mask=3):
        """Negative-to-positive frame ratio over the training corpus, per
        target, with `2*widen_target_mask+1` frames around each positive
        excluded from the negatives (behavioral contract: reference
        dataset.py:473-509).

        The downbeat ratio only counts pieces whose downbeat annotations are
        trustworthy (``downbeat_mask`` set), for both the frame total and the
        positive total.
        """
        dataset = self.train_dataset
        # one pass: per item, (#spect frames, #beat positives, #downbeat
        # positives, downbeats trustworthy?)
        table = np.array(
            [
                (
                    len(dataset._get_spect(item)),
                    len(item["beat_value"]),
                    int((item["beat_value"] == 1).sum()),
                    bool(item["downbeat_mask"]),
                )
                for item in dataset.items
            ],
            dtype=np.int64,
        ).reshape(-1, 4)
        ignored_per_positive = 2 * widen_target_mask + 1

        def ratio(kind, n_frames, n_positive):
            if n_positive == 0:
                raise ValueError(
                    "cannot compute positive weights: the training set "
                    f"contains no {kind} annotations — check the data "
                    "directory layout and whether every item was dropped "
                    "for missing augmented spectrograms"
                )
            return int(np.round((n_frames - n_positive * ignored_per_positive)
                                / n_positive))

        trusted = table[:, 3] == 1
        return {
            "beat": ratio("beat", table[:, 0].sum(), table[:, 1].sum()),
            "downbeat": ratio(
                "downbeat",
                table[trusted, 0].sum(),
                table[trusted, 2].sum(),
            ),
        }
