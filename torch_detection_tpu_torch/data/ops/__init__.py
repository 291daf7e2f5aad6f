from .bbox import (
    bbox_convert_mode,
    bbox_crop,
    bbox_flip,
    bbox_pad,
    bbox_parse,
    bbox_resize,
    bbox_valid,
)
from .image import (
    img_aspect_ratio,
    img_aspect_ratio_flag,
    img_flip,
    img_normalize,
    img_pad,
    img_pad_size_divisor,
    img_read,
    img_resize,
    pad_shape_divisor,
    png_decode,
    rescale_size,
    resize_nearest,
)
from .mask import (
    mask_flip,
    mask_pad,
    mask_parse,
    mask_resize,
    poly_to_mask,
    rle_area,
    rle_decode,
    rle_encode,
    rle_iou_matrix,
    segm_to_mask,
)

__all__ = [k for k in dir() if not k.startswith("_")]
