"""Training data pipelines: document streams -> packed, collated batches.

Re-design of the reference pipelines (`mmc4_wds.py:169-383`,
`laion_wds.py:79-282`, `mix_dataset.py`): shard stream -> per-doc
preprocessing (tokenize + image decode + interleave) -> packing buffer ->
collation to static-shape batches, with `random_mix` across sources.

A `synthetic` source generates random interleaved documents — the smoke-test
/ benchmarking source when no data is mounted.

The port's copy of `mm_interleaved_tpu/data/pipeline.py` (the port imports
nothing of the JAX package), but for `prefetch`, which keeps the data
position of the batches taken, so a resume needs no counted skip.
"""

from __future__ import annotations

import io
import queue
import threading
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

from .collators import InterleavedTrainCollator
from .mix import RandomMixIterable
from .packing import pack_sequences
from .shards import ShardedStream, read_jsonl_shard, read_tar_shard
from .tokenizer import SimpleWordTokenizer, image_subseq_ids, load_tokenizer
from .transforms import DualImageTransform, ImageTransform


def _doc_to_sample(
    doc: Dict, tokenizer, special, transform, num_img_token: int,
    img_first_prob: float, rng: np.random.RandomState,
    sim_threshold: float = 0.24, max_imgs_per_doc: int = 6,
):
    """One interleaved document -> tokenized arrays.

    Follows `preprocess_mmc4_data` (mmc4_wds.py:52-166): match images to
    sentences by similarity, cap images per doc, image-before-text with
    probability ``img_first_prob``.

    Expected doc format: {"text_list": [...], "images": [{"image":
    <bytes|array>, "sentence_idx": i, "sim": s}]} or the simpler
    {"caption": ..., "image": ...} pair form (laion_wds.py:79-157).
    """
    from PIL import Image

    img_block = image_subseq_ids(special, num_img_token)

    def load_image(im):
        if isinstance(im, tuple):  # pre-transformed (enc, dec) pair
            return tuple(np.asarray(x, np.float32) for x in im)
        if isinstance(im, (bytes, bytearray)):
            arr = Image.open(io.BytesIO(im)).convert("RGB")
            return transform(arr, rng)
        return np.asarray(im, np.float32)

    if "caption" in doc:  # pair form
        img = load_image(doc["image"])
        txt_ids = tokenizer.encode(doc["caption"])
        img_first = rng.rand() < img_first_prob
        ids = [special.bos_token_id]
        ids += (img_block + txt_ids) if img_first else (txt_ids + img_block)
        ids += [special.eos_token_id]
        enc, dec = img if isinstance(img, tuple) else (img, None)
        return dict(
            text_ids=np.asarray(ids, np.int64),
            text_attn_mask=np.ones(len(ids), np.int64),
            image_tensors=np.asarray(enc)[None],
            image_tensors_dec=(
                np.asarray(dec)[None] if dec is not None else None
            ),
        )

    # interleaved document form
    sentences = doc["text_list"]
    matches = [
        m for m in doc.get("images", [])
        if m.get("sim", 1.0) >= sim_threshold
    ][:max_imgs_per_doc]
    by_sentence: Dict[int, list] = {}
    for m in matches:
        by_sentence.setdefault(int(m.get("sentence_idx", 0)), []).append(m)

    ids = [special.bos_token_id]
    enc_imgs, dec_imgs = [], []
    for si, sent in enumerate(sentences):
        sent_ids = tokenizer.encode(sent)
        blocks = []
        for m in by_sentence.get(si, []):
            img = load_image(m["image"])
            enc, dec = img if isinstance(img, tuple) else (img, None)
            enc_imgs.append(enc)
            if dec is not None:
                dec_imgs.append(dec)
            blocks += img_block
        if blocks and rng.rand() < img_first_prob:
            ids += blocks + sent_ids
        else:
            ids += sent_ids + blocks
    ids += [special.eos_token_id]
    if not enc_imgs:
        return None
    return dict(
        text_ids=np.asarray(ids, np.int64),
        text_attn_mask=np.ones(len(ids), np.int64),
        image_tensors=np.stack(enc_imgs),
        image_tensors_dec=np.stack(dec_imgs) if dec_imgs else None,
    )


def synthetic_doc_stream(
    tokenizer, special, enc_res: int, dec_res: Optional[int],
    seed: int, vocab_hi: int = 30000,
) -> Iterator[Dict]:
    """Endless random interleaved docs (for smoke tests / data-free bench)."""
    rng = np.random.RandomState(seed)
    while True:
        n_sent = rng.randint(1, 4)
        n_img = rng.randint(1, 3)
        doc = {
            "text_list": [
                " ".join(f"w{rng.randint(vocab_hi)}"
                         for _ in range(rng.randint(4, 20)))
                for _ in range(n_sent)
            ],
            "images": [
                {
                    "image": (
                        rng.rand(enc_res, enc_res, 3).astype(np.float32)
                        if dec_res is None else
                        (rng.rand(enc_res, enc_res, 3).astype(np.float32),
                         rng.rand(dec_res, dec_res, 3).astype(np.float32))
                    ),
                    "sentence_idx": int(rng.randint(n_sent)),
                    "sim": 1.0,
                }
                for _ in range(n_img)
            ],
        }
        yield doc


def _load_synth_image(m):
    return m


def build_interleaved_source(
    source_cfg: Dict, model_cfg, tokenizer, epoch_seed: int = 0,
) -> Callable[[int], Iterator[Dict]]:
    """Factory: epoch -> packed-row iterator for one source."""
    special = tokenizer.special
    enc_res = model_cfg.visual.encoder.vit.image_size
    dec_res = (model_cfg.image_decoder.image_size
               if model_cfg.image_decoder is not None else None)
    num_img_token = model_cfg.num_img_token
    kind = source_cfg.get("name", "synthetic")
    transform = (
        DualImageTransform(enc_res, dec_res, random_flip=True)
        if dec_res else ImageTransform(enc_res, random_flip=True)
    )

    num_workers = source_cfg.get("num_workers", 0)
    img_first_prob = source_cfg.get("img_first_prob", 0.5)
    sim_threshold = source_cfg.get("sim_threshold", 0.24)
    max_imgs_per_doc = source_cfg.get("max_imgs_per_doc", 6)

    def docs_for_epoch(epoch: int) -> Iterator[Dict]:
        from .mp_loader import mp_map

        # per-document RNG (seed drawn sequentially by the parent): the
        # heavy decode/transform step becomes order-independent, so
        # `num_workers` never changes the stream
        rng = np.random.RandomState(epoch_seed + epoch)
        if kind == "synthetic":
            it = synthetic_doc_stream(
                tokenizer, special, enc_res, dec_res, epoch_seed + epoch
            )
            n = source_cfg.get("num_samples", 64)
            doc_iter = (doc for _, doc in zip(range(n), it))
            tfm = lambda a, r=None: a  # noqa: E731 — synthetic is pre-made
            kwargs = {}
        else:
            reader = (read_tar_shard if kind.endswith("tar")
                      else read_jsonl_shard)
            stream = ShardedStream(
                shard_pattern=source_cfg["input_shards"],
                shard_reader=reader,
                seed=source_cfg.get("seed", 0),
                host_id=source_cfg.get("host_id", 0),
                num_hosts=source_cfg.get("num_hosts", 1),
                sample_buffer=source_cfg.get("sample_buffer", 1000),
            )
            doc_iter = stream.iterate(epoch)
            tfm = transform
            kwargs = dict(
                sim_threshold=sim_threshold,
                max_imgs_per_doc=max_imgs_per_doc,
            )

        def seeded(docs):
            for doc in docs:
                yield doc, rng.randint(1 << 31)

        def to_sample(pair):
            doc, seed = pair
            return _doc_to_sample(
                doc, tokenizer, special, tfm, num_img_token,
                img_first_prob, np.random.RandomState(seed), **kwargs,
            )

        for s in mp_map(to_sample, seeded(doc_iter), num_workers):
            if s is not None:
                yield s

    def packed_for_epoch(epoch: int) -> Iterator[Dict]:
        return pack_sequences(
            docs_for_epoch(epoch),
            special,
            num_total_token=model_cfg.seq_len,
            num_img_token=num_img_token,
            max_num_images=model_cfg.max_num_images,
            truncation_level=source_cfg.get("truncation_level", "image"),
        )

    return packed_for_epoch


class _SyntheticSFTDataset:
    """Random LLaVA-shaped conversations with pre-transformed images —
    the data-free smoke/test source for the SFT pipeline."""

    def __init__(self, enc_res: int, dec_res: Optional[int],
                 num_samples: int = 64, seed: int = 0,
                 vocab_hi: int = 30000):
        self.enc_res, self.dec_res = enc_res, dec_res
        self.n = num_samples
        self.seed = seed
        self.vocab_hi = vocab_hi

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        n_img = int(rng.randint(1, 3))

        def img():
            enc = rng.rand(self.enc_res, self.enc_res, 3).astype(np.float32)
            if self.dec_res is None:
                return enc
            return enc, rng.rand(
                self.dec_res, self.dec_res, 3
            ).astype(np.float32)

        words = " ".join(
            f"w{rng.randint(self.vocab_hi)}" for _ in range(rng.randint(4, 12))
        )
        return dict(
            images=[img() for _ in range(n_img)],
            prompt=("<image>" * n_img) + " " + words,
            response=" ".join(
                f"w{rng.randint(self.vocab_hi)}"
                for _ in range(rng.randint(3, 10))
            ),
            index=idx,
        )


class SFTEpochIterable:
    """Map-style dataset -> RandomMix-compatible per-epoch row stream
    (``set_epoch`` reshuffles deterministically)."""

    def __init__(self, dataset, seed: int = 0, shuffle: bool = True):
        self.dataset = dataset
        self.seed = seed
        self.shuffle = shuffle
        self._epoch = 0

    def set_epoch(self, epoch: int):
        self._epoch = epoch

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + self._epoch).shuffle(order)
        for i in order:
            yield self.dataset[int(i)]


class SFTTrainCollator:
    """MultiImageCollator wrapper for training: splits the (enc, dec) image
    pairs a DualImageTransform produces, emits ``image_tensors_dec``, and
    drops host-only ``meta`` so every batch value is device-shippable."""

    def __init__(self, tokenizer, special, num_img_token: int, seq_len: int,
                 max_num_images: int):
        from .collators_extra import MultiImageCollator

        self.inner = MultiImageCollator(
            tokenizer, special, num_img_token=num_img_token, seq_len=seq_len,
            max_num_images=max_num_images, mode="train", pad_to_seq_len=True,
        )
        self.max_num_images = max_num_images

    def __call__(self, rows):
        from .collators import _stack_images

        enc_rows, dec_lists = [], []
        for r in rows:
            pairs = [
                im if isinstance(im, tuple) else (im, None)
                for im in r["images"]
            ]
            enc_rows.append({**r, "images": [p[0] for p in pairs]})
            dec_lists.append([p[1] for p in pairs if p[1] is not None])
        batch = self.inner(enc_rows)
        batch.pop("meta", None)
        if dec_lists and len(dec_lists[0]):
            dec, _ = _stack_images(
                [np.stack(d) for d in dec_lists], self.max_num_images
            )
            batch["image_tensors_dec"] = dec
        return batch


def build_sft_train_iterator(
    data_cfg: Dict, model_cfg,
) -> Tuple[Iterator[Dict], Dict]:
    """SFT training data: LLaVA-style conversation datasets ->
    MultiImageCollator train batches (reference `sft_datasets.py` +
    `collator_sft.py`, launched by its SFT stage).  Selected by
    ``task: sft`` in the data config."""
    from .datasets_extra import LLaVADataset, WeightedConcatDataset

    tokenizer = load_tokenizer(
        data_cfg.get("tokenizer_path"),
        vocab_size=model_cfg.llm.vocab_size,
        special=model_cfg.special,
    )
    enc_res = model_cfg.visual.encoder.vit.image_size
    dec_res = (model_cfg.image_decoder.image_size
               if model_cfg.image_decoder is not None else None)
    transform = (
        DualImageTransform(enc_res, dec_res, random_flip=True)
        if dec_res else ImageTransform(enc_res, random_flip=True)
    )
    sources = data_cfg.get("datasets", [{"name": "synthetic_sft"}])
    datasets, weights = [], []
    for s in sources:
        if s.get("name", "synthetic_sft") == "synthetic_sft":
            datasets.append(_SyntheticSFTDataset(
                enc_res, dec_res,
                num_samples=s.get("num_samples", 64),
                seed=s.get("seed", 0),
            ))
        else:  # llava-style annotation json
            datasets.append(LLaVADataset(
                annt_file=s["annt_file"],
                data_root=s.get("data_root", "."),
                transform=transform,
                total_length=s.get("total_length"),
            ))
        weights.append(float(s.get("weight", 1.0)))
    dataset = (
        datasets[0] if len(datasets) == 1
        else WeightedConcatDataset(
            datasets, weights, seed=data_cfg.get("seed", 0)
        )
    )
    rows = SFTEpochIterable(dataset, seed=data_cfg.get("seed", 0))
    collator = SFTTrainCollator(
        tokenizer, tokenizer.special,
        num_img_token=model_cfg.num_img_token,
        seq_len=model_cfg.seq_len,
        max_num_images=model_cfg.max_num_images,
    )
    it = StatefulTrainIterator(
        rows, collator, data_cfg.get("per_device_batch_size", 2)
    )
    first = next(it)
    it.restore({"epoch": 0, "offset": 0})
    return it, first


def build_train_iterator(
    data_cfg: Dict, model_cfg,
) -> Tuple[Iterator[Dict], Dict]:
    """(endless batch iterator, example batch) for the Trainer."""
    if data_cfg.get("task") == "sft":
        return build_sft_train_iterator(data_cfg, model_cfg)
    tokenizer = load_tokenizer(
        data_cfg.get("tokenizer_path"),
        vocab_size=model_cfg.llm.vocab_size,
        special=model_cfg.special,
    )
    sources = data_cfg.get("datasets", [{"name": "synthetic"}])
    factories = [
        build_interleaved_source(s, model_cfg, tokenizer,
                                 epoch_seed=data_cfg.get("seed", 0))
        for s in sources
    ]
    mix = RandomMixIterable(
        factories,
        probs=data_cfg.get("probs"),
        sampling_type=data_cfg.get("sampling_type", "longest"),
        seed=data_cfg.get("seed", 0),
    )
    collator = InterleavedTrainCollator(
        tokenizer.special,
        seq_len=model_cfg.seq_len,
        max_num_images=model_cfg.max_num_images,
        has_dec_images=model_cfg.image_decoder is not None,
    )
    batch_size = data_cfg.get("per_device_batch_size", 2)

    it = StatefulTrainIterator(mix, collator, batch_size)
    first = next(it)
    # rewind so training replays the peeked batch (deterministic streams)
    it.restore({"epoch": 0, "offset": 0})
    return it, first


class StatefulTrainIterator:
    """Endless epoch-looping batch iterator with checkpointable position.

    Replaces the reference's counted-skip WebLoader resume
    (lmm_trainer.py:1021-1057): `state()` returns {"epoch", "offset"}
    (batches already yielded within the epoch); `restore()` re-seeds the
    deterministic per-epoch streams and fast-forwards only *within* the
    epoch — O(offset) host work bounded by one epoch, instead of replaying
    the whole run, and robust to pipeline-config changes across epochs.
    """

    def __init__(self, mix, collator, batch_size: int):
        self.mix = mix
        self.collator = collator
        self.batch_size = batch_size
        self.epoch = 0
        self.offset = 0
        self._gen: Optional[Iterator[Dict]] = None

    def _epoch_gen(self, epoch: int) -> Iterator[Dict]:
        self.mix.set_epoch(epoch)
        buf = []
        for row in self.mix:
            buf.append(row)
            if len(buf) == self.batch_size:
                yield self.collator(buf)
                buf = []

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        while True:
            if self._gen is None:
                self._gen = self._epoch_gen(self.epoch)
            try:
                batch = next(self._gen)
                self.offset += 1
                return batch
            except StopIteration:
                self.epoch += 1
                self.offset = 0
                self._gen = None

    def state(self) -> Dict[str, int]:
        return {"epoch": int(self.epoch), "offset": int(self.offset)}

    def restore(self, state: Dict[str, int]):
        self.epoch = int(state["epoch"])
        self.offset = 0
        self._gen = self._epoch_gen(self.epoch)
        for _ in range(int(state["offset"])):
            next(self._gen)
            self.offset += 1
        return self


def prefetch(it, size: int = 2) -> "Prefetched":
    """Background-thread prefetch of ``size`` batches (replaces torch
    DataLoader workers for the host-side pipeline; pairs with the native
    C++ pixel kernels), keeping the data position (`Prefetched`)."""
    return Prefetched(it, size)


class Prefetched:
    """The batches of ``it`` made ``size`` ahead by a background thread.

    `state()` is ``it``'s position after the last batch taken (None where
    ``it`` has no `state`): the thread's iterator runs up to ``size`` + 1
    batches ahead, so its own `state()` would resume past batches no step
    took.  An error of the data path is raised by the `next` that would
    have taken its batch; `close()` stops the thread."""

    def __init__(self, it, size: int = 2):
        self._stateful = hasattr(it, "state")
        self._state = it.state() if self._stateful else None
        self._queue: "queue.Queue" = queue.Queue(maxsize=size)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, args=(it,),
                                        daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _work(self, it) -> None:
        try:
            for batch in it:
                state = it.state() if self._stateful else None
                if not self._put((batch, state)):
                    return
            self._put(StopIteration())
        except Exception as e:  # noqa: BLE001 — raised again by __next__
            self._put(e)

    def __iter__(self):
        return self

    def __next__(self) -> Dict:
        item = self._queue.get()
        if isinstance(item, StopIteration):
            self._queue.put(item)
            raise StopIteration
        if isinstance(item, Exception):
            raise RuntimeError("the data pipeline failed") from item
        batch, self._state = item
        return batch

    def state(self) -> Optional[Dict[str, int]]:
        return None if self._state is None else dict(self._state)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=60)
