"""COLMAP preprocessing wrapper (port of
`gaussian_mesh_splatting_tpu/apps/convert.py`): runs the external `colmap`
binary (feature extraction, matching, mapping, undistortion) on
{source}/input, moves the sparse model into sparse/0, and with `--resize`
writes images_2/4/8 pyramids with PIL. It has no device.

    python -m gaussian_mesh_splatting_tpu_torch.apps.convert -s <source> \\
        [--skip_matching] [--resize] [--colmap_executable colmap]
"""
from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys


def run(cmd: str) -> None:
    print(f"+ {cmd}")
    code = subprocess.call(cmd, shell=True)
    if code != 0:
        print(f"command failed with code {code}. Exiting.")
        sys.exit(code)


def main(argv=None):
    p = argparse.ArgumentParser("convert")
    p.add_argument("--source_path", "-s", required=True)
    p.add_argument("--no_gpu", action="store_true")
    p.add_argument("--skip_matching", action="store_true")
    p.add_argument("--camera", default="OPENCV")
    p.add_argument("--colmap_executable", default="colmap")
    p.add_argument("--resize", action="store_true")
    args = p.parse_args(argv)

    colmap = args.colmap_executable
    use_gpu = 0 if args.no_gpu else 1
    src = args.source_path

    if not args.skip_matching:
        os.makedirs(os.path.join(src, "distorted/sparse"), exist_ok=True)
        run(f"{colmap} feature_extractor"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --ImageReader.single_camera 1"
            f" --ImageReader.camera_model {args.camera}"
            f" --SiftExtraction.use_gpu {use_gpu}")
        run(f"{colmap} exhaustive_matcher"
            f" --database_path {src}/distorted/database.db"
            f" --SiftMatching.use_gpu {use_gpu}")
        run(f"{colmap} mapper"
            f" --database_path {src}/distorted/database.db"
            f" --image_path {src}/input"
            f" --output_path {src}/distorted/sparse"
            f" --Mapper.ba_global_function_tolerance=0.000001")

    run(f"{colmap} image_undistorter"
        f" --image_path {src}/input"
        f" --input_path {src}/distorted/sparse/0"
        f" --output_path {src}"
        f" --output_type COLMAP")

    # the undistorter writes the sparse model's files into sparse/: move
    # them into sparse/0, where the readers look
    sparse = os.path.join(src, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f == "0":
            continue
        shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))

    if args.resize:
        from PIL import Image

        images = os.path.join(src, "images")
        for factor in (2, 4, 8):
            out_dir = os.path.join(src, f"images_{factor}")
            os.makedirs(out_dir, exist_ok=True)
            for name in os.listdir(images):
                with Image.open(os.path.join(images, name)) as im:
                    im.resize((im.width // factor, im.height // factor)).save(
                        os.path.join(out_dir, name))
        print("generated images_2/4/8 pyramids")
    print("Done.")


if __name__ == "__main__":
    main()
