"""ShapeNet dataset wrappers.

Port of ``kaolin_tpu/io/shapenet.py`` (reference
``kaolin/io/shapenet.py:100-478``). Meshes load onto ``device``.
Directory layouts:
V1: ``root/{synset}/{model}/model.obj``;
V2: ``root/{synset}/{model}/models/model_normalized.obj``.
"""

import os

from .dataset import KaolinDataset
from . import obj

__all__ = ['ShapeNetV1', 'ShapeNetV2', 'synset_to_labels',
           'labels_to_synsets']

# common subset of the synset/label map (kaolin/io/shapenet.py:24-80)
synset_to_labels = {
    '02691156': ['airplane', 'aeroplane', 'plane'],
    '02828884': ['bench'],
    '02933112': ['cabinet'],
    '02958343': ['car', 'auto', 'automobile', 'machine', 'motorcar'],
    '03001627': ['chair'],
    '03211117': ['display', 'video display'],
    '03636649': ['lamp'],
    '03691459': ['loudspeaker', 'speaker', 'speaker unit'],
    '04090263': ['rifle'],
    '04256520': ['sofa', 'couch', 'lounge'],
    '04379243': ['table'],
    '04401088': ['telephone', 'phone', 'telephone set'],
    '04530566': ['vessel', 'watercraft'],
}
labels_to_synsets = {label: synset
                     for synset, labels in synset_to_labels.items()
                     for label in labels}


def _resolve_synsets(categories):
    out = []
    for c in categories:
        if c in synset_to_labels:
            out.append(c)
        elif c in labels_to_synsets:
            out.append(labels_to_synsets[c])
        else:
            out.append(c)  # assume raw synset id
    return out


class _ShapeNetBase(KaolinDataset):

    MODEL_REL_PATH = None

    def __init__(self, root, categories=None, train=True, split=0.7,
                 with_materials=False, device='cuda'):
        self.root = root
        self.device = device
        self.with_materials = with_materials
        if categories is None:
            categories = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d)))
        synsets = _resolve_synsets(categories)
        self.paths = []
        self.synset_idxs = []
        self.synsets = synsets
        self.labels = [synset_to_labels.get(s, [s])[0] for s in synsets]
        for s_idx, synset in enumerate(synsets):
            syn_dir = os.path.join(root, synset)
            if not os.path.isdir(syn_dir):
                raise ValueError(f'Category {synset} not found in {root}')
            models = sorted(
                m for m in os.listdir(syn_dir)
                if os.path.isdir(os.path.join(syn_dir, m)))
            cutoff = int(len(models) * split)
            models = models[:cutoff] if train else models[cutoff:]
            for m in models:
                self.paths.append(os.path.join(syn_dir, m))
                self.synset_idxs.append(s_idx)

    def __len__(self):
        return len(self.paths)

    def get_data(self, index):
        path = os.path.join(self.paths[index], self.MODEL_REL_PATH)
        return obj.import_mesh(path, with_materials=self.with_materials,
                               error_handler=obj.skip_error_handler,
                               device=self.device)

    def get_attributes(self, index):
        s_idx = self.synset_idxs[index]
        return {'name': os.path.basename(self.paths[index]),
                'path': self.paths[index],
                'synset': self.synsets[s_idx],
                'labels': synset_to_labels.get(self.synsets[s_idx],
                                               [self.synsets[s_idx]])}


class ShapeNetV1(_ShapeNetBase):
    """ShapeNetCore v1 (reference ``io/shapenet.py:100``)."""
    MODEL_REL_PATH = 'model.obj'


class ShapeNetV2(_ShapeNetBase):
    """ShapeNetCore v2 (reference ``io/shapenet.py:288``)."""
    MODEL_REL_PATH = os.path.join('models', 'model_normalized.obj')
