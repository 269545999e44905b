"""Material model: PBR materials with USD-Preview-Surface-style parameters.

Port of ``kaolin_tpu/io/materials.py`` (reference
``kaolin/io/materials.py:36-763``). Textures are (C, H, W) tensors; PIL is
imported only where an image is read or written. The USD methods go
through ``.usd`` (a material with values only needs no PIL). The OBJ
material round-trip uses the public PBR extension
tags of .mtl (Pr/Pm/Pc/Pcr/norm/...); the reference declares
``write_to_obj``/``read_from_obj`` abstract (``materials.py:240-244``).
"""

import os
import warnings

import numpy as np
import torch

__all__ = [
    'MaterialError',
    'MaterialLoadError',
    'MaterialFileError',
    'MaterialNotFoundError',
    'MaterialNotSupportedError',
    'MaterialWriteError',
    'MaterialManager',
    'Material',
    'PBRMaterial',
]


class MaterialError(Exception):
    pass


class MaterialLoadError(MaterialError):
    pass


class MaterialFileError(MaterialError):
    pass


class MaterialNotFoundError(MaterialError):
    pass


class MaterialNotSupportedError(MaterialError):
    pass


class MaterialWriteError(MaterialError):
    pass


class Material:
    """Abstract material base (reference ``materials.py:226``)."""

    def __init__(self, name=None):
        self.material_name = name or ''

    def write_to_usd(self, file_path, scene_path, **kwargs):
        raise NotImplementedError

    def read_from_usd(self, file_path, scene_path, **kwargs):
        raise NotImplementedError

    def write_to_obj(self, obj_dir=None, texture_dir=None,
                     texture_prefix=''):
        raise NotImplementedError

    def read_from_obj(self, file_path):
        raise NotImplementedError


_VALUE_FIELDS = {
    'diffuse_color': (0.5, 0.5, 0.5),
    'roughness_value': 0.5,
    'metallic_value': 0.,
    'clearcoat_value': 0.,
    'clearcoat_roughness_value': 0.01,
    'opacity_value': 1.0,
    'opacity_threshold': 0.,
    'ior_value': 1.5,
    'specular_color': (0., 0., 0.),
    'displacement_value': 0.,
}

_TEXTURE_FIELDS = [
    'diffuse_texture', 'roughness_texture', 'metallic_texture',
    'clearcoat_texture', 'clearcoat_roughness_texture', 'opacity_texture',
    'ior_texture', 'specular_texture', 'normals_texture',
    'displacement_texture',
]

# one colorspace token per texture slot (reference materials.py:312-315,
# 371-395): 'auto' | 'raw' | 'sRGB' — carried as metadata, like pxr.
_COLORSPACE_FIELDS = [
    'diffuse_colorspace', 'roughness_colorspace', 'metallic_colorspace',
    'clearcoat_colorspace', 'clearcoat_roughness_colorspace',
    'opacity_colorspace', 'ior_colorspace', 'specular_colorspace',
    'normals_colorspace', 'displacement_colorspace',
]

_VALID_COLORSPACES = {'auto', 'raw', 'srgb'}

# .mtl record tag <-> PBRMaterial field, using the public PBR extension
# tags (Pr roughness, Pm metallic, Pc clearcoat, Pcr clearcoat
# roughness, Ni ior, d dissolve/opacity, norm normal map, disp
# displacement)
_MTL_VALUE_TAGS = {
    'Kd': 'diffuse_color',
    'Ks': 'specular_color',
    'Pr': 'roughness_value',
    'Pm': 'metallic_value',
    'Pc': 'clearcoat_value',
    'Pcr': 'clearcoat_roughness_value',
    'd': 'opacity_value',
    'Ni': 'ior_value',
}
_MTL_TEXTURE_TAGS = {
    'map_Kd': 'diffuse_texture',
    'map_Ks': 'specular_texture',
    'map_Pr': 'roughness_texture',
    'map_Pm': 'metallic_texture',
    'map_Pc': 'clearcoat_texture',
    'map_Pcr': 'clearcoat_roughness_texture',
    'map_d': 'opacity_texture',
    'norm': 'normals_texture',
    'disp': 'displacement_texture',
}


def _texture_to_image(tex):
    """(C, H, W) float [0,1] -> PIL Image (uint8)."""
    from PIL import Image
    arr = tex.detach().cpu().numpy() if torch.is_tensor(tex) \
        else np.asarray(tex)
    if arr.ndim == 3:
        arr = np.transpose(arr, (1, 2, 0))
    if arr.ndim == 3 and arr.shape[-1] == 1:
        arr = arr[..., 0]
    return Image.fromarray(np.clip(arr * 255., 0., 255.).astype(np.uint8))


def _image_to_texture(path, device):
    """Image file -> (C, H, W) float [0,1] on ``device``."""
    from PIL import Image
    arr = np.asarray(Image.open(path)).astype(np.float32) / 255.
    if arr.ndim == 2:
        arr = arr[None]
    else:
        arr = np.transpose(arr, (2, 0, 1))
    return torch.as_tensor(np.ascontiguousarray(arr), device=device)


def _numpy(tex):
    return tex.detach().cpu().numpy() if torch.is_tensor(tex) \
        else np.asarray(tex)


class PBRMaterial(Material):
    """Physically-based material (USD Preview Surface parameter set).

    Reference: ``kaolin/io/materials.py:248``. Value fields default as in
    the reference; texture fields are (C, H, W) tensors or None; each
    texture slot carries a colorspace token ('auto'/'raw'/'sRGB').
    """

    def __init__(self, name='', is_specular_workflow=False, **kwargs):
        super().__init__(name)
        self.is_specular_workflow = is_specular_workflow
        for field, default in _VALUE_FIELDS.items():
            val = kwargs.pop(field, default)
            if isinstance(val, (tuple, list)) or (
                    isinstance(val, np.ndarray) and val.ndim):
                val = tuple(float(v) for v in val)
            elif val is not None:
                val = float(val)
            setattr(self, field, val)
        for field in _TEXTURE_FIELDS:
            setattr(self, field, kwargs.pop(field, None))
        for field in _COLORSPACE_FIELDS:
            cs = kwargs.pop(field, 'auto')
            if cs.lower() not in _VALID_COLORSPACES:
                raise MaterialLoadError(
                    f'Colorspace {cs} is not supported. Valid values are '
                    f'[auto, sRGB, raw]')
            setattr(self, field, cs)
        if kwargs:
            raise TypeError(f"PBRMaterial got unexpected arguments "
                            f"{sorted(kwargs)}")

    # --- serialization ---------------------------------------------------
    def to_dict(self):
        out = {'material_name': self.material_name,
               'is_specular_workflow': self.is_specular_workflow}
        for field in _VALUE_FIELDS:
            out[field] = getattr(self, field)
        for field in _TEXTURE_FIELDS:
            tex = getattr(self, field)
            out[field] = None if tex is None else _numpy(tex)
        for field in _COLORSPACE_FIELDS:
            out[field] = getattr(self, field)
        return out

    @classmethod
    def from_dict(cls, d, device='cuda'):
        """The material of :meth:`to_dict`, its textures on ``device``."""
        d = dict(d)
        name = d.pop('material_name', '')
        spec = d.pop('is_specular_workflow', False)
        kwargs = {}
        for field in _VALUE_FIELDS:
            if field in d:
                kwargs[field] = d.pop(field)
        for field in _TEXTURE_FIELDS:
            tex = d.pop(field, None)
            if tex is not None:
                tex = torch.as_tensor(tex, device=device)
            kwargs[field] = tex
        for field in _COLORSPACE_FIELDS:
            if field in d:
                kwargs[field] = d.pop(field)
        return cls(name=name, is_specular_workflow=spec, **kwargs)

    # --- USD -------------------------------------------------------------
    def write_to_usd(self, file_path, scene_path, texture_dir='.',
                     bound_prims=None):
        """Appends this material to a USD file through
        :func:`kaolin_tpu_torch.io.usd.add_material`."""
        from . import usd
        return usd.add_material(file_path, scene_path, self,
                                texture_dir=texture_dir,
                                bind_to=bound_prims)

    @classmethod
    def read_from_usd(cls, file_path, scene_path, texture_path=None,
                      time=None, device='cuda'):
        """Reads a material written by :meth:`write_to_usd` (or a pxr
        UsdPreviewSurface tree), its textures on ``device``."""
        from . import usd
        return usd.import_material(file_path, scene_path,
                                   texture_path=texture_path, time=time,
                                   device=device)

    # --- OBJ / MTL -------------------------------------------------------
    def write_to_obj(self, obj_dir=None, texture_dir=None,
                     texture_prefix=''):
        """Writes this material as a ``.mtl`` material library.

        Value fields map to standard + PBR-extension MTL tags (Kd, Ks,
        d, Ni, Pr, Pm, Pc, Pcr); textures are written as PNGs under
        ``texture_dir`` and referenced with their map_* tags. Returns
        the path of the written .mtl file. (The reference declares this
        abstract at ``materials.py:240``.)
        """
        name = self.material_name or 'material_0'
        obj_dir = obj_dir or '.'
        texture_dir = texture_dir if texture_dir is not None else obj_dir
        os.makedirs(obj_dir, exist_ok=True)
        os.makedirs(texture_dir, exist_ok=True)
        lines = [f'newmtl {name}']
        for tag, field in _MTL_VALUE_TAGS.items():
            val = getattr(self, field)
            if isinstance(val, tuple):
                lines.append(tag + ' ' + ' '.join('%.6f' % v for v in val))
            else:
                lines.append('%s %.6f' % (tag, val))
        lines.append('illum %d' % (3 if self.is_specular_workflow else 2))
        for tag, field in _MTL_TEXTURE_TAGS.items():
            tex = getattr(self, field)
            if tex is None:
                continue
            if field == 'normals_texture':   # stored in [-1, 1]
                tex = _numpy(tex) * 0.5 + 0.5
            fname = f'{texture_prefix}{name}_{field}.png'
            _texture_to_image(tex).save(os.path.join(texture_dir, fname))
            rel = os.path.relpath(os.path.join(texture_dir, fname), obj_dir)
            lines.append(f'{tag} {rel}')
        mtl_path = os.path.join(obj_dir, f'{name}.mtl')
        with open(mtl_path, 'w', encoding='utf-8') as stream:
            stream.write('\n'.join(lines) + '\n')
        return mtl_path

    @classmethod
    def read_from_obj(cls, file_path, material_name=None, device='cuda'):
        """Reads a material from a ``.mtl`` library (or the ``mtllib``
        of an ``.obj``). Standard + PBR-extension tags are decoded; the
        reference declares this abstract at ``materials.py:244``.

        Args:
            file_path (str): path to a .mtl or .obj file.
            material_name (str, optional): which newmtl section to read
                (default: the first one).
            device: where the textures land.
        """
        if file_path.endswith('.obj'):
            mtl_path = None
            with open(file_path, 'r', encoding='utf-8') as stream:
                for line in stream:
                    tokens = line.split()
                    if tokens and tokens[0] == 'mtllib':
                        mtl_path = os.path.join(
                            os.path.dirname(file_path), tokens[1])
                        break
            if mtl_path is None:
                raise MaterialNotFoundError(
                    f'no mtllib record in {file_path}')
            file_path = mtl_path
        root_dir = os.path.dirname(file_path)
        try:
            with open(file_path, 'r', encoding='utf-8') as stream:
                records = [line.split() for line in stream]
        except Exception as exc:
            raise MaterialFileError(
                f"Failed to load material at path '{file_path}':\n{exc}")
        sections = {}
        bucket = None
        for rec in records:
            if not rec:
                continue
            if rec[0] == 'newmtl':
                bucket = sections.setdefault(rec[1], [])
            elif bucket is not None:
                bucket.append(rec)
        if not sections:
            raise MaterialNotFoundError(f'no materials in {file_path}')
        if material_name is None:
            material_name = next(iter(sections))
        elif material_name not in sections:
            raise MaterialNotFoundError(
                f"'{material_name}' not found in {file_path}")
        kwargs = {}
        specular_seen = False
        for rec in sections[material_name]:
            tag, args = rec[0], rec[1:]
            if tag in _MTL_VALUE_TAGS:
                vals = [float(v) for v in args]
                kwargs[_MTL_VALUE_TAGS[tag]] = (
                    tuple(vals) if len(vals) > 1 else vals[0])
                specular_seen |= tag == 'Ks' and any(vals)
            elif tag in _MTL_TEXTURE_TAGS:
                tex = _image_to_texture(os.path.join(root_dir, args[-1]),
                                        device)
                field = _MTL_TEXTURE_TAGS[tag]
                if field == 'normals_texture':
                    tex = tex * 2. - 1.
                kwargs[field] = tex
            elif tag == 'illum':
                kwargs['is_specular_workflow'] = int(args[0]) >= 3
        if 'is_specular_workflow' not in kwargs:
            kwargs['is_specular_workflow'] = (
                specular_seen and 'metallic_value' not in kwargs)
        return cls(name=material_name, **kwargs)

    def __repr__(self):
        set_tex = [f for f in _TEXTURE_FIELDS
                   if getattr(self, f) is not None]
        return (f"PBRMaterial(name={self.material_name!r}, "
                f"diffuse_color={self.diffuse_color}, textures={set_tex})")


class MaterialManager:
    """Registry mapping USD shader ids to reader functions
    (reference ``kaolin/io/materials.py:90``). Import paths consult it
    to decide how to decode a bound shader; new shaders register a
    ``reader_fn(params: dict, texture_path: str, time) -> Material``.
    """
    _usd_readers = {}
    _obj_reader = None

    @classmethod
    def register_usd_reader(cls, shader_name, reader_fn):
        if shader_name in cls._usd_readers:
            warnings.warn(f'Shader {shader_name} is already registered; '
                          'overwriting the existing reader.')
        if not callable(reader_fn):
            raise MaterialLoadError(
                'The supplied `reader_fn` must be a callable function.')
        cls._usd_readers[shader_name] = reader_fn

    @classmethod
    def get_usd_reader(cls, shader_name):
        return cls._usd_readers.get(shader_name)

    @classmethod
    def register_obj_reader(cls, reader_fn):
        """Registers the ``.obj``/``.mtl`` material reader used by
        :meth:`read_from_file` (``reader_fn(file_path) -> Material``)."""
        cls._obj_reader = reader_fn

    @classmethod
    def read_from_file(cls, file_path, scene_path=None, texture_path=None,
                       time=None):
        r"""Reads a material file and returns a Material object
        (reference ``materials.py:136``): ``.usd``/``.usda``/``.usdc``
        dispatch on the bound shader's registered reader;
        ``.obj``/``.mtl`` use the registered obj reader
        (:meth:`PBRMaterial.read_from_obj` by default).
        """
        ext = os.path.splitext(file_path)[1]
        if ext in ('.usd', '.usda', '.usdc'):
            if not scene_path or not str(scene_path).startswith('/'):
                raise MaterialLoadError(
                    f'The scene_path `{scene_path}` provided is invalid.')
            from . import usd
            return usd.import_material(file_path, scene_path,
                                       texture_path=texture_path,
                                       time=time)
        if ext in ('.obj', '.mtl'):
            if cls._obj_reader is not None:
                return cls._obj_reader(file_path)
            raise MaterialNotSupportedError(
                'No registered .obj material reader found.')
        raise MaterialNotSupportedError(
            f'Material file type {ext!r} is not supported.')

    @classmethod
    def read_usd_material(cls, stage, material_path, texture_path=None,
                          time=None, device='cuda'):
        r"""Reads a material prim from an open stage (reference
        ``materials.py:176``) through ``.usd``, its textures on
        ``device``. Dispatches on the surface shader's ``info:id``
        through the registered readers.
        """
        from . import usd
        return usd._import_material_from_stage(
            stage, material_path, texture_path=texture_path, time=time,
            device=device)


# UsdPreviewSurface belongs to the USD module (it needs stage access to
# chase UsdUVTexture connections, which the 3-arg reader_fn signature
# cannot express); the registry covers additional shaders.

# default .obj reader (the reference raises MaterialNotSupportedError
# unless one is registered; this build registers its own PBR reader)
MaterialManager.register_obj_reader(PBRMaterial.read_from_obj)
