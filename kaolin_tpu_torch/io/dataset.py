"""Dataset wrappers: disk caching, preprocessing, combination.

Port of ``kaolin_tpu/io/dataset.py`` (reference
``kaolin/io/dataset.py:125-581``). Datasets follow the standard
``__len__`` / ``__getitem__`` protocol (usable with any loader, including
``torch.utils.data.DataLoader``); cached samples are stored as pickle
files of pytrees whose tensors became numpy arrays, and are read back as
numpy, as the JAX package's are.
"""

import hashlib
import os
import pickle
from abc import abstractmethod
from collections import namedtuple
import multiprocessing

import numpy as np
import torch
from torch.utils import _pytree as pytree

__all__ = ['Cache', 'CachedDataset', 'KaolinDataset', 'ProcessedDataset',
           'CombinationDataset']

KaolinDatasetItem = namedtuple('KaolinDatasetItem', ['data', 'attributes'])


def _leaf_to_numpy(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    return np.asarray(x) if hasattr(x, 'shape') else x


def _to_numpy(tree):
    return pytree.tree_map(_leaf_to_numpy, tree)


class Cache:
    """Caches function outputs to disk, by name key.

    Reference: ``kaolin/io/dataset.py:304``.
    """

    def __init__(self, func, cache_dir, cache_key):
        self.func = func
        self.cache_dir = os.path.abspath(cache_dir)
        self.cache_key = cache_key
        os.makedirs(self.cache_dir, exist_ok=True)
        self.cached_ids = {
            os.path.splitext(p)[0] for p in os.listdir(self.cache_dir)
            if p.endswith('.pkl')}

    def _path(self, object_id):
        safe = hashlib.sha1(str(object_id).encode()).hexdigest()[:16] \
            if os.sep in str(object_id) else str(object_id)
        return os.path.join(self.cache_dir, f'{safe}.pkl')

    def __call__(self, unique_id, *args, **kwargs):
        path = self._path(unique_id)
        if os.path.exists(path):
            with open(path, 'rb') as f:
                return pickle.load(f)
        out = _to_numpy(self.func(*args, **kwargs))
        with open(path, 'wb') as f:
            pickle.dump(out, f)
        self.cached_ids.add(str(unique_id))
        return out

    def try_get(self, unique_id):
        path = self._path(unique_id)
        if os.path.exists(path):
            with open(path, 'rb') as f:
                return pickle.load(f)
        return None


def _cache_worker(args):
    cache_dir, i, sample = args
    path = os.path.join(cache_dir, f'{i}.pkl')
    with open(path, 'wb') as f:
        pickle.dump(_to_numpy(sample), f)
    return i


class CachedDataset:
    """Caches a dataset's (optionally preprocessed) samples on disk.

    Reference: ``kaolin/io/dataset.py:125``.

    Args:
        dataset: source dataset (``__len__`` / ``__getitem__``).
        cache_dir (str): where to store the cache.
        save_on_disk (bool): write samples at construction. Default True.
        num_workers (int): worker processes that write the cache
            (0 = in-process); the samples are made here.
        transform: optional preprocessing applied before caching.
        force_overwrite (bool): rebuild the cache.
    """

    def __init__(self, dataset, cache_dir, save_on_disk=True,
                 num_workers=0, transform=None, force_overwrite=False):
        self.cache_dir = os.path.abspath(cache_dir)
        os.makedirs(self.cache_dir, exist_ok=True)
        self._len = len(dataset)
        self.transform = transform
        if save_on_disk:
            todo = [i for i in range(self._len)
                    if force_overwrite or not os.path.exists(
                        os.path.join(self.cache_dir, f'{i}.pkl'))]
            if todo:
                def prep(i):
                    s = dataset[i]
                    return self.transform(s) if self.transform else s
                if num_workers > 0:
                    ctx = multiprocessing.get_context('spawn')
                    with ctx.Pool(num_workers) as pool:
                        pool.map(_cache_worker,
                                 [(self.cache_dir, i, _to_numpy(prep(i)))
                                  for i in todo])
                else:
                    for i in todo:
                        _cache_worker((self.cache_dir, i, prep(i)))

    def __len__(self):
        return self._len

    def __getitem__(self, idx):
        with open(os.path.join(self.cache_dir, f'{idx}.pkl'), 'rb') as f:
            return pickle.load(f)


class KaolinDataset:
    """Dataset base returning (data, attributes) named tuples.

    Reference: ``kaolin/io/dataset.py:379``.
    """

    def __getitem__(self, index):
        return KaolinDatasetItem(data=self.get_data(index),
                                 attributes=self.get_attributes(index))

    @abstractmethod
    def get_data(self, index):
        pass

    @abstractmethod
    def get_attributes(self, index):
        pass

    @abstractmethod
    def __len__(self):
        pass


class ProcessedDataset(KaolinDataset):
    """Applies (and optionally caches) a preprocessing transform on data.

    Reference: ``kaolin/io/dataset.py:419``.
    """

    def __init__(self, dataset, preprocessing_transform=None,
                 cache_dir=None, num_workers=0):
        self.dataset = dataset
        self.transform = preprocessing_transform
        self.cache = None
        if cache_dir is not None and preprocessing_transform is not None:
            self.cache = Cache(preprocessing_transform, cache_dir,
                               cache_key='processed')

    def __len__(self):
        return len(self.dataset)

    def get_data(self, index):
        item = self.dataset[index]
        data = item.data if isinstance(item, KaolinDatasetItem) else item
        if self.cache is not None:
            return self.cache(index, data)
        if self.transform is not None:
            return self.transform(data)
        return data

    def get_attributes(self, index):
        item = self.dataset[index]
        if isinstance(item, KaolinDatasetItem):
            return item.attributes
        return {}


class CombinationDataset(KaolinDataset):
    """Zips multiple datasets of identical length.

    Reference: ``kaolin/io/dataset.py:536``.
    """

    def __init__(self, datasets):
        self.len = len(datasets[0])
        for ds in datasets:
            assert len(ds) == self.len, \
                "All datasets must have the same length"
        self.datasets = datasets

    def __len__(self):
        return self.len

    def get_data(self, index):
        return tuple(
            d[index].data if isinstance(d[index], KaolinDatasetItem)
            else d[index] for d in self.datasets)

    def get_attributes(self, index):
        return tuple(
            d[index].attributes if isinstance(d[index], KaolinDatasetItem)
            else {} for d in self.datasets)
