"""Semantic-KITTI label database (standard public label set; the reference
vendors the same table at ros/launch/semantic-kitti.yaml and consumes it at
ros/launch/odometry.launch.py:69-81 for point-cloud colorization)."""

from __future__ import annotations

import numpy as np

LABEL_NAMES = {
    0: "unlabeled",
    1: "outlier",
    10: "car",
    11: "bicycle",
    13: "bus",
    15: "motorcycle",
    16: "on-rails",
    18: "truck",
    20: "other-vehicle",
    30: "person",
    31: "bicyclist",
    32: "motorcyclist",
    40: "road",
    44: "parking",
    48: "sidewalk",
    49: "other-ground",
    50: "building",
    51: "fence",
    52: "other-structure",
    60: "lane-marking",
    70: "vegetation",
    71: "trunk",
    72: "terrain",
    80: "pole",
    81: "traffic-sign",
    99: "other-object",
    252: "moving-car",
    253: "moving-bicyclist",
    254: "moving-person",
    255: "moving-motorcyclist",
    256: "moving-on-rails",
    257: "moving-bus",
    258: "moving-truck",
    259: "moving-other-vehicle",
}

# BGR, as in the semantic-kitti dev-kit
COLOR_MAP_BGR = {
    0: (0, 0, 0),
    1: (0, 0, 255),
    10: (245, 150, 100),
    11: (245, 230, 100),
    13: (250, 80, 100),
    15: (150, 60, 30),
    16: (255, 0, 0),
    18: (180, 30, 80),
    20: (255, 0, 0),
    30: (30, 30, 255),
    31: (200, 40, 255),
    32: (90, 30, 150),
    40: (255, 0, 255),
    44: (255, 150, 255),
    48: (75, 0, 75),
    49: (75, 0, 175),
    50: (0, 200, 255),
    51: (50, 120, 255),
    52: (0, 150, 255),
    60: (170, 255, 150),
    70: (0, 175, 0),
    71: (0, 60, 135),
    72: (80, 240, 150),
    80: (150, 240, 255),
    81: (0, 0, 255),
    99: (255, 255, 50),
    252: (245, 150, 100),
    253: (200, 40, 255),
    254: (30, 30, 255),
    255: (90, 30, 150),
    256: (255, 0, 0),
    257: (250, 80, 100),
    258: (180, 30, 80),
    259: (255, 0, 0),
}

# single-scan learning ids (semantic-kitti dev-kit learning_map)
LEARNING_MAP = {
    0: 0, 1: 0, 10: 1, 11: 2, 13: 5, 15: 3, 16: 5, 18: 4, 20: 5, 30: 6,
    31: 7, 32: 8, 40: 9, 44: 10, 48: 11, 49: 12, 50: 13, 51: 14, 52: 0,
    60: 9, 70: 15, 71: 16, 72: 17, 80: 18, 81: 19, 99: 0, 252: 1, 253: 7,
    254: 6, 255: 8, 256: 5, 257: 5, 258: 4, 259: 5,
}

LEARNING_MAP_INV = {
    0: 0, 1: 10, 2: 11, 3: 15, 4: 18, 5: 20, 6: 30, 7: 31, 8: 32, 9: 40,
    10: 44, 11: 48, 12: 49, 13: 50, 14: 51, 15: 70, 16: 71, 17: 72,
    18: 80, 19: 81,
}


def color_lut_rgb(num_labels: int = 260) -> np.ndarray:
    """label -> packed RGB int (the reference packs (r<<16)|(g<<8)|b at
    odometry.launch.py:77-80)."""
    lut = np.zeros((num_labels,), dtype=np.uint32)
    for k, (b, g, r) in COLOR_MAP_BGR.items():
        lut[k] = (int(r) << 16) | (int(g) << 8) | int(b)
    return lut


def rgb_lut_float(num_labels: int = 260) -> np.ndarray:
    """label -> (r, g, b) in [0, 1], for visualization dumps."""
    lut = np.zeros((num_labels, 3), dtype=np.float32)
    for k, (b, g, r) in COLOR_MAP_BGR.items():
        lut[k] = (r / 255.0, g / 255.0, b / 255.0)
    return lut


def remap_learning(labels: np.ndarray) -> np.ndarray:
    lut = np.zeros((260,), dtype=np.int32)
    for k, v in LEARNING_MAP.items():
        lut[k] = v
    return lut[np.clip(labels, 0, 259)]
