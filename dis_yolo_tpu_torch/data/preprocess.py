"""Offline ground-truth cache for a split (the counterpart of
``dis_yolo_tpu/data/preprocess.py``).  It contours the class masks with
OpenCV, imported when a function runs: without OpenCV it raises (the
card's machine has none; build the cache elsewhere, or write it as
``chip_smoke.py`` does).

Behavioral port of ``pre_process.py`` (reference): per split, read the
per-class binary mask JPEGs, extract contours with full hierarchy (parent =
outer boundary, child = interior hole), optionally group multiple contours
into one instance using PASCAL-VOC 'merge' boxes, and write

  * ``<split>.txt``               — image id list (one stem per line)
  * ``ground_truth_cache.pkl``    — list of
      {'filename': 'x.jpg',
       'regions': {'0': {'region_attributes': classname,
                         'shape_attributes': [{'type': 'in'|'out',
                                               'all_points_x': [...],
                                               'all_points_y': [...]}, ...]},
                   ...},
       'size': [height, width]}
    (schema documented at pre_process.py:334-364)

Class priority for merged boxes: crack > spall > rebar (pre_process.py:214-221).
Classes are processed in the fixed order crack, spall, rebar so region
numbering matches the reference (:90-159).
"""

from __future__ import annotations

import os
import pickle
import xml.etree.ElementTree as ET
from typing import Dict, List, Tuple

import numpy as np

CLASS_ORDER = ("crack", "spall", "rebar")


def _cv2():
    try:
        import cv2
    except ImportError as e:
        raise RuntimeError("OpenCV required for offline preprocessing") from e
    return cv2


def _parse_merge_boxes(xml_path: str) -> List[List[float]]:
    """Extract 'merge' bndboxes (0-based, like the reference's -1 shift)."""
    tree = ET.parse(xml_path)
    boxes = []
    for obj in tree.findall("object"):
        if obj.find("name").text.lower().strip() != "merge":
            continue
        bb = obj.find("bndbox")
        boxes.append([float(bb.find(k).text) - 1
                      for k in ("xmin", "ymin", "xmax", "ymax")])
    return boxes


def _contours_with_hierarchy(mask_path: str):
    """Binary threshold at 127 + RETR_TREE full-pixel contours."""
    cv2 = _cv2()
    img = cv2.imread(mask_path, cv2.IMREAD_GRAYSCALE)
    _, thresh = cv2.threshold(img, 127, 255, 0)
    res = cv2.findContours(thresh, cv2.RETR_TREE, cv2.CHAIN_APPROX_NONE)
    contours, hierarchy = res[-2], res[-1]   # cv2 3.x returns 3-tuple
    return contours, hierarchy


def _regions_from_class_masks(mask_dir: str, stem: str) -> Tuple[Dict, int]:
    """Build the per-image regions dict from the 3 class-mask JPEGs.

    Top-level contours become 'out' polygons of new regions; child contours
    become 'in' (hole) polygons appended to their parent's region.
    Grandchild contours are reported as mask errors and skipped.
    """
    regions: Dict[str, Dict] = {}
    count = 0
    errors = 0
    for classname in CLASS_ORDER:
        path = os.path.join(mask_dir, f"{stem}{classname}.jpg")
        if not os.path.exists(path):
            continue
        contours, hierarchy = _contours_with_hierarchy(path)
        if hierarchy is None:
            continue
        parent_to_region: Dict[int, int] = {}
        for j, contour in enumerate(contours):
            pts = contour[:, 0, :]
            all_x = pts[:, 0].tolist()
            all_y = pts[:, 1].tolist()
            parent = int(hierarchy[0, j, 3])
            if parent == -1:
                regions[str(count)] = {
                    "region_attributes": classname,
                    "shape_attributes": [
                        {"type": "out", "all_points_x": all_x, "all_points_y": all_y}
                    ],
                }
                parent_to_region[j] = count
                count += 1
            else:
                if int(hierarchy[0, parent, 3]) != -1:
                    print(f"There may be errors in mask {stem}{classname}.jpg")
                    errors += 1
                    continue
                ridx = parent_to_region[parent]
                regions[str(ridx)]["shape_attributes"].append(
                    {"type": "in", "all_points_x": all_x, "all_points_y": all_y})
    return regions, errors


def _merge_regions(regions: Dict, merge_boxes: List[List[float]],
                   filename: str) -> Dict:
    """Group instances whose outer-contour centroid lies in a merge box.

    Assignment = the merge box containing the centroid with the nearest
    center (pre_process.py:176-205); the merged region's class follows
    priority crack > spall (without rebar) > rebar (:214-221).
    """
    cv2 = _cv2()
    groups: List[List[Dict]] = [[] for _ in merge_boxes]
    names: List[List[str]] = [[] for _ in merge_boxes]

    for k in range(len(regions)):
        region = regions[str(k)]
        polys = region["shape_attributes"]
        outer = polys[0]
        pts = np.stack([outer["all_points_x"], outer["all_points_y"]], axis=1)
        contour = pts[:, None, :].astype(np.int32)
        mom = cv2.moments(contour)
        if mom["m00"] == 0:
            print(f"No merged box belongs to the defect in {filename}")
            continue
        cx, cy = int(mom["m10"] / mom["m00"]), int(mom["m01"] / mom["m00"])

        best, best_d = None, float("inf")
        for i, (x1, y1, x2, y2) in enumerate(merge_boxes):
            if cx <= x1 or cx >= x2 or cy <= y1 or cy >= y2:
                continue
            d = np.hypot((x1 + x2) / 2 - cx, (y1 + y2) / 2 - cy)
            if d < best_d:
                best, best_d = i, d
        if best is None:
            print(f"No merged box belongs to the defect in {filename}")
            continue
        groups[best].extend(polys)
        names[best].append(region["region_attributes"])

    merged: Dict[str, Dict] = {}
    count = 0
    for i in range(len(merge_boxes)):
        if not groups[i]:
            print(f"No defect belongs to this merged box {filename}")
            continue
        nl = names[i]
        if "crack" in nl:
            cls = "crack"
        elif "spall" in nl and "rebar" not in nl:
            cls = "spall"
        else:
            cls = "rebar"
        merged[str(count)] = {"region_attributes": cls, "shape_attributes": groups[i]}
        count += 1
    return merged


def build_ground_truth_cache(data_path: str, phase: str = "train",
                             force: bool = False) -> List[Dict]:
    """Build (or load) the GT cache for one split; returns the annotations."""
    cv2 = _cv2()
    split_dir = os.path.join(data_path, phase)
    img_dir = os.path.join(split_dir, "images")
    mask_dir = os.path.join(split_dir, "masks")
    anno_dir = os.path.join(split_dir, "annotations")
    cache_dir = os.path.join(split_dir, "cache")
    os.makedirs(cache_dir, exist_ok=True)
    cache_file = os.path.join(cache_dir, "ground_truth_cache.pkl")

    if os.path.isfile(cache_file) and not force:
        with open(cache_file, "rb") as f:
            return pickle.load(f)

    stems = sorted(os.path.splitext(f)[0] for f in os.listdir(img_dir)
                   if f.lower().endswith(".jpg"))
    annotations = []
    total_errors = 0
    with open(os.path.join(cache_dir, f"{phase}.txt"), "w") as idlist:
        for stem in stems:
            idlist.write(stem + "\n")
            regions, errs = _regions_from_class_masks(mask_dir, stem)
            total_errors += errs
            xml_path = os.path.join(anno_dir, stem + ".xml")
            if os.path.exists(xml_path):
                merge_boxes = _parse_merge_boxes(xml_path)
                regions = _merge_regions(regions, merge_boxes, stem + ".jpg")
            img = cv2.imread(os.path.join(img_dir, stem + ".jpg"))
            h, w = img.shape[:2]
            annotations.append({"filename": stem + ".jpg",
                                "regions": regions, "size": [h, w]})

    print(f"Number of error mask is {total_errors}")
    with open(cache_file, "wb") as f:
        pickle.dump(annotations, f)
    return annotations
