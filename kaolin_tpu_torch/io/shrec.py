"""SHREC16 dataset wrapper.

Port of ``kaolin_tpu/io/shrec.py`` (reference
``kaolin/io/shrec.py:97-239``). Layout:
``root/{category}/{split}/{model}.obj`` with splits 'train' / 'test'.
"""

import os

from .dataset import KaolinDataset
from . import obj

__all__ = ['SHREC16']


class SHREC16(KaolinDataset):
    """SHREC16 (ShapeNet Core55 contest) dataset of OBJ meshes, loaded
    onto ``device``."""

    def __init__(self, root, categories=None, split='train', device='cuda'):
        assert split in ('train', 'val', 'test'), \
            f"split must be 'train', 'val' or 'test' but got {split}"
        self.root = root
        self.device = device
        if categories is None:
            categories = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d)))
        self.paths = []
        self.labels = []
        self.categories = categories
        for cat in categories:
            cat_dir = os.path.join(root, cat, split)
            if not os.path.isdir(cat_dir):
                raise ValueError(f'Category {cat} ({split}) not found '
                                 f'in {root}')
            for name in sorted(os.listdir(cat_dir)):
                if name.endswith('.obj'):
                    self.paths.append(os.path.join(cat_dir, name))
                    self.labels.append(cat)

    def __len__(self):
        return len(self.paths)

    def get_data(self, index):
        return obj.import_mesh(self.paths[index],
                               error_handler=obj.skip_error_handler,
                               device=self.device)

    def get_attributes(self, index):
        return {'name': os.path.basename(self.paths[index]),
                'path': self.paths[index],
                'label': self.labels[index]}
