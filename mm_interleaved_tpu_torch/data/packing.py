"""Sequence packing: concatenate tokenized documents into fixed-length rows.

Host-side numpy re-design of the reference packing buffer
(`custom_datasets/wds_utils.py:389-518`: `concat_sample`/`extract_seq`/
`check_image_truncate`):

  * documents accumulate in a buffer; each yield slices ``num_total_token``
    tokens and the matching images off the front;
  * the image cap (`max_num_images`) truncates at the preceding image or
    document boundary;
  * a ``<soi>`` whose image block would be cut by the row boundary is pushed
    back into the buffer (image- or sample-level truncation);
  * rows with zero images are dropped (reference extract_seq:512-513).

Yields dicts: text_ids [T], text_attn_mask [T], image_tensors [n, H, W, 3],
optional image_tensors_dec, nearest_bos_idxs [n], meta.

The port's copy of `mm_interleaved_tpu/data/packing.py` (the port imports
nothing of the JAX package).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np

from .tokenizer import SpecialIds


def calc_nearest_bos_token_idxs(
    text_ids: np.ndarray, bos_token_id: int, soi_token_id: int
) -> np.ndarray:
    """Nearest preceding <bos> for each <soi> (wds_utils.py:275-298);
    0 when none precedes."""
    soi = np.nonzero(text_ids == soi_token_id)[0]
    bos = np.nonzero(text_ids == bos_token_id)[0]
    bos = np.insert(bos, 0, 0)
    out = []
    for s in soi:
        prior = bos[bos < s]
        out.append(int(prior.max()) if len(prior) else 0)
    return np.asarray(out, dtype=np.int64)


def _split_buffer(buffers: Dict, n_tok: int, n_img: int):
    data = dict(
        text_ids=buffers["text_ids"][:n_tok],
        text_attn_mask=buffers["text_attn_mask"][:n_tok],
        image_tensors=buffers["image_tensors"][:n_img],
        image_tensors_dec=(
            buffers["image_tensors_dec"][:n_img]
            if buffers.get("image_tensors_dec") is not None else None
        ),
    )
    buffers = dict(
        text_ids=buffers["text_ids"][n_tok:],
        text_attn_mask=buffers["text_attn_mask"][n_tok:],
        image_tensors=buffers["image_tensors"][n_img:],
        image_tensors_dec=(
            buffers["image_tensors_dec"][n_img:]
            if buffers.get("image_tensors_dec") is not None else None
        ),
    )
    return data, buffers


def extract_seq(
    buffers: Dict,
    special: SpecialIds,
    num_total_token: int = 2048,
    num_img_token: int = 64,
    max_num_images: int = -1,
    truncation_level: str = "image",
):
    """Slice one packed row off the buffer (wds_utils.py:389-474)."""
    assert truncation_level in ("image", "sample")
    ids = buffers["text_ids"]
    n_tok = num_total_token

    num_images = int(
        np.count_nonzero(ids[:n_tok] == special.image_token_id)
    ) // num_img_token
    if max_num_images > 0 and num_images > max_num_images:
        soi = np.nonzero(ids == special.soi_token_id)[0]
        if truncation_level == "sample":
            next_soi = soi[max_num_images]
            bos_before = np.nonzero(
                ids[:next_soi] == special.bos_token_id
            )[0]
            last_bos = bos_before[-1]
            n_tok = int(last_bos if last_bos > soi[max_num_images - 1]
                        else next_soi)
        else:
            n_tok = int(soi[max_num_images - 1] + num_img_token + 1)
        num_images = max_num_images

    data, buffers = _split_buffer(buffers, n_tok, num_images)
    meta = dict(is_truncated=0)

    # push a cut image block back into the buffer (wds_utils.py:301-370)
    soi = np.nonzero(data["text_ids"] == special.soi_token_id)[0]
    if len(soi) > 0:
        last = int(soi[-1])
        if last >= len(data["text_ids"]) - num_img_token:
            meta["is_truncated"] = 1
            if truncation_level == "sample":
                bos = np.nonzero(
                    data["text_ids"] == special.bos_token_id
                )[0]
                cut = int(bos[-1]) if len(bos) else 0
            else:
                cut = last
            for key in ("text_ids", "text_attn_mask"):
                keep, left = data[key][:cut], data[key][cut:]
                data[key] = keep
                buffers[key] = np.concatenate((left, buffers[key]), axis=0)
            if truncation_level == "sample":
                n_keep = int(
                    np.count_nonzero(
                        data["text_ids"] == special.image_token_id
                    )
                ) // num_img_token
                for key in ("image_tensors", "image_tensors_dec"):
                    if data.get(key) is None:
                        continue
                    keep, left = data[key][:n_keep], data[key][n_keep:]
                    data[key] = keep
                    buffers[key] = np.concatenate(
                        (left, buffers[key]), axis=0
                    )

    num_images = int(
        np.count_nonzero(data["text_ids"] == special.image_token_id)
    ) // num_img_token
    if num_images <= 0:
        return None, buffers

    data["nearest_bos_idxs"] = calc_nearest_bos_token_idxs(
        data["text_ids"], special.bos_token_id, special.soi_token_id
    )
    soi = np.nonzero(data["text_ids"] == special.soi_token_id)[0]
    meta["image_cnt"] = num_images
    meta["is_first_token_image"] = int(
        data["text_ids"][0] == special.soi_token_id
        or (len(data["text_ids"]) > 1
            and data["text_ids"][0] == special.bos_token_id
            and data["text_ids"][1] == special.soi_token_id)
    )
    data["meta"] = meta
    return data, buffers


def pack_sequences(
    samples: Iterator[Dict],
    special: SpecialIds,
    num_total_token: int = 2048,
    num_img_token: int = 64,
    max_num_images: int = -1,
    truncation_level: str = "image",
    partial: bool = False,
) -> Iterator[Dict]:
    """The `concat_sample` buffer loop (wds_utils.py:477-518).

    ``samples`` yield dicts with text_ids [T] (int64), text_attn_mask [T],
    image_tensors [n, ...] and optionally image_tensors_dec.
    """
    buffers = dict(text_ids=None, text_attn_mask=None, image_tensors=None,
                   image_tensors_dec=None)

    def emit():
        return extract_seq(
            buffers, special,
            num_total_token=num_total_token,
            num_img_token=num_img_token,
            max_num_images=max_num_images,
            truncation_level=truncation_level,
        )

    for sample in samples:
        while (buffers["text_ids"] is not None
               and len(buffers["text_ids"]) >= num_total_token):
            out, buffers = emit()
            if out is not None:
                yield out
        if buffers["text_ids"] is None:
            for k, v in sample.items():
                if v is not None:
                    buffers[k] = np.asarray(v).copy()
        else:
            for k, v in sample.items():
                if v is not None:
                    buffers[k] = np.concatenate(
                        (buffers[k], np.asarray(v)), axis=0
                    )

    if buffers["text_ids"] is None or len(buffers["text_ids"]) == 0:
        return
    if len(buffers["text_ids"]) >= num_total_token or partial:
        out, _ = emit()
        if out is not None:
            yield out
