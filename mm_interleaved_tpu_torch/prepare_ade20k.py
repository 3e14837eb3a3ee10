"""Render ADE20k class-id annotation maps to palette-colour PNGs
(counterpart of `scripts/prepare_ade20k.py`).

The segmentation-to-image benchmark conditions the image decoder on a
colour-rendered segmentation map and scores the generated photo's mIoU
after mapping pixels back to the nearest palette class (reference
custom_datasets/ade20k_preparation.py, engine/lmm_trainer.py:1534-1556).
This writes the ``annotations_with_color/{split}`` directory that
`data.datasets_bench.ADE20kDataset` reads, with the same palette
(`ade20k_official_palette`, class i -> row i; class id 0 = unlabeled stays
black).

    python -m mm_interleaved_tpu_torch.prepare_ade20k \\
        --data_root ./assets/ade20k/ADEChallengeData2016 --split validation
"""

from __future__ import annotations

import argparse
import os

import numpy as np
from PIL import Image

from .data.datasets_bench import ade20k_official_palette


def render_split(data_root: str, split: str, verify_images: bool = True
                 ) -> int:
    """Render every ``annotations/{split}/*.png`` under ``data_root``;
    returns the number of maps written."""
    segm_dir = os.path.join(data_root, "annotations", split)
    image_dir = os.path.join(data_root, "images", split)
    out_dir = os.path.join(data_root, "annotations_with_color", split)
    os.makedirs(out_dir, exist_ok=True)

    # rows 1..150 are class colours; row 0 (unlabeled) renders black
    palette = ade20k_official_palette().astype(np.uint8)

    names = sorted(n for n in os.listdir(segm_dir) if n.endswith(".png"))
    if not names:
        raise SystemExit(f"no annotation PNGs under {segm_dir}")
    for i, name in enumerate(names):
        if verify_images:
            jpg = os.path.join(image_dir, name.replace(".png", ".jpg"))
            if not os.path.isfile(jpg):
                raise SystemExit(f"missing photo for {name}: {jpg}")
        ids = np.asarray(Image.open(os.path.join(segm_dir, name)))
        # class ids are 1..150 with 0 = unlabeled; direct palette lookup
        rgb = palette[np.clip(ids, 0, len(palette) - 1)]
        rgb[ids == 0] = 0
        Image.fromarray(rgb).save(os.path.join(out_dir, name))
        if (i + 1) % 500 == 0:
            print(f"{i + 1}/{len(names)}", flush=True)
    print(f"rendered {len(names)} maps -> {out_dir}")
    return len(names)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_root", required=True,
                    help="ADEChallengeData2016 directory")
    ap.add_argument("--split", default="validation",
                    choices=["training", "validation"])
    ap.add_argument("--no_verify_images", action="store_true")
    args = ap.parse_args(argv)
    return render_split(args.data_root, args.split,
                        verify_images=not args.no_verify_images)


if __name__ == "__main__":
    main()
