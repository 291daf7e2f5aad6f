"""The C++ matchers of the evaluators (``native/eval_match.cpp``), through
ctypes.

``match_image`` is the VOC protocol's greedy matcher on boxes,
``coco_match`` COCO's ``evaluateImg`` matching on any IoU matrix at every
threshold at once, and ``iou_matrix`` the boxes' IoU. Each gives what the
plain Python version in ``engine/eval.py`` gives. The library is built by
g++ at first use (``native.load``); without g++ they raise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from . import load

_F64 = ctypes.POINTER(ctypes.c_double)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def _lib() -> ctypes.CDLL:
    lib = load("eval_match")
    if not getattr(lib, "_typed", False):
        i64, f64 = ctypes.c_int64, ctypes.c_double
        lib.td_match_image.argtypes = [_F64, i64, _F64, i64, _U8, _F64, i64, f64, f64, _U8, _U8]
        lib.td_match_image.restype = None
        lib.td_coco_match.argtypes = [_F64, i64, i64, _U8, _U8, _F64, i64, _U8, _U8]
        lib.td_coco_match.restype = None
        lib.td_iou_matrix.argtypes = [_F64, i64, _F64, i64, f64, _F64]
        lib.td_iou_matrix.restype = None
        lib._typed = True
    return lib


def _f64(a, cols: int = 0) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.float64)
    return a.reshape(-1, cols) if cols else a.reshape(-1)


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, bool).reshape(-1), dtype=np.uint8)


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


def match_image(det_boxes: np.ndarray, gt_boxes: np.ndarray, gt_ignore: np.ndarray,
                ignore_regions: np.ndarray, iou_thr: float, offset: float = 1.0
                ) -> Tuple[np.ndarray, np.ndarray]:
    """(matched, det_ignored), each (D,) bool, of score-sorted ``det_boxes``
    against ``gt_boxes`` and the ``ignore_regions``."""
    det, gt, regions = _f64(det_boxes, 4), _f64(gt_boxes, 4), _f64(ignore_regions, 4)
    ig = _u8(gt_ignore)
    if len(ig) != len(gt):
        raise ValueError(f"{len(ig)} gt_ignore flags for {len(gt)} gts")
    matched = np.zeros(len(det), np.uint8)
    det_ignored = np.zeros(len(det), np.uint8)
    _lib().td_match_image(_ptr(det, _F64), len(det), _ptr(gt, _F64), len(gt), _ptr(ig, _U8),
                          _ptr(regions, _F64), len(regions), float(iou_thr), float(offset),
                          _ptr(matched, _U8), _ptr(det_ignored, _U8))
    return matched.astype(bool), det_ignored.astype(bool)


def coco_match(iou: np.ndarray, gt_ig: np.ndarray, gt_crowd: np.ndarray,
               iou_thrs: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(matched, ignored), each (T, D) bool, of a (D, G) IoU matrix whose gt
    columns are ordered non-ignored first."""
    d, g = iou.shape
    m = _f64(iou)
    ig, crowd, thrs = _u8(gt_ig), _u8(gt_crowd), _f64(iou_thrs)
    if len(ig) != g or len(crowd) != g:
        raise ValueError(f"{len(ig)} gt_ig and {len(crowd)} gt_crowd flags for {g} gt columns")
    matched = np.zeros((len(thrs), d), np.uint8)
    ignored = np.zeros((len(thrs), d), np.uint8)
    _lib().td_coco_match(_ptr(m, _F64), d, g, _ptr(ig, _U8), _ptr(crowd, _U8), _ptr(thrs, _F64),
                         len(thrs), _ptr(matched, _U8), _ptr(ignored, _U8))
    return matched.astype(bool), ignored.astype(bool)


def iou_matrix(a: np.ndarray, b: np.ndarray, offset: float = 1.0) -> np.ndarray:
    """(N, M) IoU of boxes ``a`` and ``b``."""
    a, b = _f64(a, 4), _f64(b, 4)
    out = np.zeros((len(a), len(b)), np.float64)
    _lib().td_iou_matrix(_ptr(a, _F64), len(a), _ptr(b, _F64), len(b), float(offset),
                         _ptr(out, _F64))
    return out
