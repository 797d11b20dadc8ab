"""Offline BOP -> PoET-COCO annotation converters (YCB-V, LM-O). A copy of
`poet_tpu/data/converters.py` (the port imports nothing of `poet_tpu`) that
reads the image size from the first PNG's header instead of opening it with
PIL; a JPEG-only split (train_pbr) waits for the nvJPEG item, ROADMAP A.1.

Parity targets: data_utils/data_annotation/ycbv2poet.py and lmo2poet.py —
visib_fract < 0.05 filter, bbox clamping to the image frame, mm -> m
translations, per-image intrinsics, image types (real/synt/pbr), keyframe
subsetting from a keyframes.txt list, and the LM-O raw-object-id remap
{1,5,6,8,9,10,11,12} -> {1..8}.

Pure host Python; exposed as a library function + `python -m
poet_tpu_torch.data.converters` CLI.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

YCBV_CLASSES = [
    "002_master_chef_can", "003_cracker_box", "004_sugar_box",
    "005_tomato_soup_can", "006_mustard_bottle", "007_tuna_fish_can",
    "008_pudding_box", "009_gelatin_box", "010_potted_meat_can",
    "011_banana", "019_pitcher_base", "021_bleach_cleanser", "024_bowl",
    "025_mug", "035_power_drill", "036_wood_block", "037_scissors",
    "040_large_marker", "051_large_clamp", "052_extra_large_clamp",
    "061_foam_brick",
]

LMO_CLASSES = ["ape", "can", "cat", "driller", "duck", "eggbox", "glue", "holepuncher"]
# LM-O ships objects with raw BOP ids {1,5,6,8,9,10,11,12} (lmo2poet.py)
LMO_ID_MAP = {1: 1, 5: 2, 6: 3, 8: 4, 9: 5, 10: 6, 11: 7, 12: 8}


def vendored_keyframes_path() -> str:
    """Path to the shipped YCB-V keyframe list (2,949 frames).

    This is the exact data asset the reference consumes to define the
    `keyframes`/`keyframes_bop` eval splits used by most papers
    (data_utils/data_annotation/keyframes.txt, read at ycbv2poet.py:57-65
    and matched at :140-144) — vendored under dataset_files/ so a migrating
    user reproduces the paper's eval split without the reference checkout.
    """
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
        "dataset_files", "keyframes.txt")


def load_keyframes(path: Optional[str] = None) -> List[str]:
    """Read a keyframes list (`SSSS/FFFFFF` per line); default = vendored."""
    with open(path or vendored_keyframes_path()) as f:
        return [line.rstrip() for line in f]


def _categories(names: Sequence[str]) -> List[dict]:
    cats = [{"supercategory": "background", "id": 0, "name": "background"}]
    cats += [
        {"supercategory": n, "id": i + 1, "name": n} for i, n in enumerate(names)
    ]
    return cats


def convert_bop_to_poet(
    base_path: str,
    data_paths: Sequence[str],
    img_types: Sequence[str],
    output_file: str,
    image_size: Optional[Tuple[int, int]] = None,
    min_visib_fract: float = 0.05,
    keyframes: Optional[Sequence[str]] = None,
    obj_id_map: Optional[Dict[int, int]] = None,
    class_names: Sequence[str] = YCBV_CLASSES,
) -> dict:
    """Convert BOP-format scene dirs into one PoET-COCO annotation JSON.

    Mirrors ycbv2poet.py:107-216: walks `<base>/<data_path>/<scene>/`, reads
    scene_gt.json / scene_gt_info.json / scene_camera.json, filters barely
    visible objects, clamps boxes, scales translations mm -> m.

    image_size (W, H) defaults to autodetecting from the first rgb image
    (the reference hardcodes 640x480, ycbv2poet.py:158-180).
    """
    if image_size is None:
        from poet_tpu_torch.native import image_size as header_size

        for data_path in data_paths:
            for scene in sorted(os.listdir(os.path.join(base_path, data_path))):
                rgb = os.path.join(base_path, data_path, scene, "rgb")
                if os.path.isdir(rgb):
                    first = sorted(os.listdir(rgb))[0]
                    with open(os.path.join(rgb, first), "rb") as f:
                        image_size = header_size(f.read())    # (W, H), PNG or JPEG
                    break
            if image_size:
                break
        assert image_size, f"no rgb images under {base_path}/{data_paths}"
    W, H = image_size
    out = {"images": [], "categories": _categories(class_names), "annotations": []}
    image_id = 0
    annotation_id = 0
    removed = 0
    kf = set(keyframes) if keyframes is not None else None

    for data_path, img_type in zip(data_paths, img_types):
        scenes = sorted(
            d.name for d in os.scandir(os.path.join(base_path, data_path)) if d.is_dir()
        )
        for scene in scenes:
            scene_dir = os.path.join(base_path, data_path, scene)
            rgb_dir = os.path.join(scene_dir, "rgb")
            img_names = sorted(
                f for f in os.listdir(rgb_dir) if f.rsplit(".", 1)[-1] in ("png", "jpg")
            )
            with open(os.path.join(scene_dir, "scene_gt_info.json")) as f:
                bbox_ann = json.load(f)
            with open(os.path.join(scene_dir, "scene_gt.json")) as f:
                pose_ann = json.load(f)
            with open(os.path.join(scene_dir, "scene_camera.json")) as f:
                cam_ann = json.load(f)
            if not (len(bbox_ann) == len(pose_ann) == len(cam_ann) == len(img_names)):
                raise ValueError(f"annotation count mismatch in {scene_dir}")

            for img_name, bk, pk, ck in zip(img_names, bbox_ann, pose_ann, cam_ann):
                if kf is not None:
                    key = scene[2:] + "/" + img_name.rsplit(".", 1)[0]
                    if key not in kf:
                        continue
                n_in_image = 0
                for bbox, pose in zip(bbox_ann[bk], pose_ann[pk]):
                    if bbox["visib_fract"] < min_visib_fract:
                        removed += 1
                        continue
                    obj_id = pose["obj_id"]
                    if obj_id_map is not None:
                        if obj_id not in obj_id_map:
                            continue
                        obj_id = obj_id_map[obj_id]
                    b = list(bbox["bbox_obj"])            # xywh
                    # clamp to the frame (ycbv2poet.py:158-180)
                    if b[0] < 0:
                        b[2] += b[0]
                        b[0] = 0
                    if b[1] < 0:
                        b[3] += b[1]
                        b[1] = 0
                    if b[0] + b[2] >= W:
                        b[2] = W - b[0] - 1
                    if b[1] + b[3] >= H:
                        b[3] = H - b[1] - 1
                    out["annotations"].append(
                        {
                            "id": annotation_id,
                            "image_id": image_id,
                            "relative_pose": {
                                "position": [t / 1000.0 for t in pose["cam_t_m2c"]],
                                "rotation": pose["cam_R_m2c"],
                            },
                            "bbox": b,
                            "bbox_info": bbox,
                            "area": b[2] * b[3],
                            "iscrowd": 0,
                            "category_id": obj_id,
                        }
                    )
                    annotation_id += 1
                    n_in_image += 1
                if n_in_image == 0:
                    continue
                out["images"].append(
                    {
                        "file_name": os.path.join(data_path, scene, "rgb", img_name),
                        "id": image_id,
                        "width": W,
                        "height": H,
                        "intrinsics": cam_ann[ck]["cam_K"],
                        "type": img_type,
                    }
                )
                image_id += 1

    os.makedirs(os.path.dirname(output_file) or ".", exist_ok=True)
    with open(output_file, "w") as f:
        json.dump(out, f)
    print(f"wrote {output_file}: {image_id} images, {annotation_id} annotations, "
          f"{removed} removed (visib_fract < {min_visib_fract})")
    return out


def main():
    p = argparse.ArgumentParser("BOP -> PoET annotation converter")
    p.add_argument("--dataset", choices=["ycbv", "lmo"], required=True)
    p.add_argument("--base_path", required=True)
    p.add_argument("--split", default="train",
                   help="comma-separated BOP subdirs, e.g. train_real,train_synt")
    p.add_argument("--types", default="real", help="comma-separated image types")
    p.add_argument("--output", required=True)
    p.add_argument(
        "--keyframes", nargs="?", default=None, const="vendored",
        help="path to keyframes.txt; bare `--keyframes` (or the literal "
             "`vendored`) uses the shipped YCB-V list under dataset_files/")
    args = p.parse_args()

    kf = None
    if args.keyframes:
        kf = load_keyframes(
            None if args.keyframes == "vendored" else args.keyframes)
    convert_bop_to_poet(
        args.base_path,
        args.split.split(","),
        args.types.split(","),
        args.output,
        keyframes=kf,
        obj_id_map=LMO_ID_MAP if args.dataset == "lmo" else None,
        class_names=LMO_CLASSES if args.dataset == "lmo" else YCBV_CLASSES,
    )


if __name__ == "__main__":
    main()
