"""Video preprocessing CLI (the port of the JAX package's
``cli/preprocess_video.py``; reference ``benchmark/video/preprocess.py:
79-105``).

Usage:
  python -m multi_modal_csi_tpu_torch.cli.preprocess_video --model Swin-T \\
      --path_data_x dataset/video --path_data_y dataset/annotation.csv \\
      --path_data_pre_x dataset/cache [--threads 4] [--backend torch|cv2] \\
      [--check]

Decodes every annotated clip (``<label>.mp4``, with cv2), applies the
backbone's published transform and caches the normalized float32 (T, H,
W, 3) array as ``<label>.npy``; prints each label whose frame count is not
90 with "Warning!". ``--backend cv2`` resizes with cv2 (threads scale; at
most one uint8 step from torchvision's resize); ``--check`` only sweeps
the frame counts. Offline host work: it needs cv2, and no card.
"""

from __future__ import annotations

import argparse
import time

from ..data.annotation import label_list, load_annotation
from ..data.video_io import (VIDEO_TRANSFORMS, check_video_integrity,
                             preprocess_video_dir)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--path_data_x", default="dataset/video")
    p.add_argument("--path_data_y", default="dataset/annotation.csv")
    p.add_argument("--model", default="Swin-T",
                   choices=sorted(VIDEO_TRANSFORMS))
    p.add_argument("--path_data_pre_x", default="dataset/cache")
    p.add_argument("--threads", default=4, type=int)
    p.add_argument("--backend", default=None, choices=["torch", "cv2"],
                   help="resize backend: torch = torchvision's (default), "
                        "cv2 = threads scale, at most one uint8 step off")
    p.add_argument("--check", action="store_true",
                   help="only report clips whose frame count is not 90")
    args = p.parse_args(argv)

    labels = label_list(load_annotation(args.path_data_y))
    print(len(labels))
    t0 = time.time()
    if args.check:
        bad = check_video_integrity(args.path_data_x, labels)
    else:
        bad = preprocess_video_dir(args.path_data_x, labels, args.model,
                                   args.path_data_pre_x,
                                   num_threads=args.threads,
                                   backend=args.backend)
    for label in bad:
        print(label, "Warning!")
    print("Preprocess Time:", time.time() - t0)


if __name__ == "__main__":
    main()
