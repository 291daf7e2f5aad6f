from .config import Config, ConfigDict, merge_dicts
from .file_handler import dump, load
from .misc import file_is_exist, is_list_of, is_str, random_scale, to_array
from .registry import BACKBONES, DATASETS, DETECTORS, HEADS, NECKS, Registry

__all__ = [
    "Config",
    "ConfigDict",
    "merge_dicts",
    "dump",
    "load",
    "file_is_exist",
    "is_list_of",
    "is_str",
    "random_scale",
    "to_array",
    "BACKBONES",
    "DATASETS",
    "DETECTORS",
    "HEADS",
    "NECKS",
    "Registry",
]
