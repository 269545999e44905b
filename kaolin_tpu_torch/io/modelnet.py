"""ModelNet dataset wrapper.

Port of ``kaolin_tpu/io/modelnet.py`` (reference
``kaolin/io/modelnet.py:26-134``). Layout:
``root/{category}/{split}/{model}.off``.
"""

import os

from .dataset import KaolinDataset
from . import off

__all__ = ['ModelNet']


class ModelNet(KaolinDataset):
    """ModelNet10/40 dataset of OFF meshes, loaded onto ``device``."""

    def __init__(self, root, categories=None, split='train', device='cuda'):
        assert split in ('train', 'test'), \
            f"split must be 'train' or 'test' but got {split}"
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
                if name.endswith('.off'):
                    self.paths.append(os.path.join(cat_dir, name))
                    self.labels.append(cat)

    def __len__(self):
        return len(self.paths)

    def get_data(self, index):
        return off.import_mesh(self.paths[index], device=self.device)

    def get_attributes(self, index):
        return {'name': os.path.basename(self.paths[index]),
                'path': self.paths[index],
                'label': self.labels[index]}
