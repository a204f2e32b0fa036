"""String-keyed component registries (counterpart of
``arcnerf_tpu/utils/registry.py``): models, encoders, nets, bounds and
datasets register under a name and are built from config ``type`` fields.
"""


class Registry:

    def __init__(self, name):
        self._name = name
        self._obj_map = {}

    @property
    def name(self):
        return self._name

    def register(self, obj=None, name=None):
        if obj is None:  # used as decorator @REG.register()
            def deco(cls):
                self._do_register(name or cls.__name__, cls)
                return cls

            return deco
        self._do_register(name or obj.__name__, obj)
        return obj

    def _do_register(self, name, obj):
        if name in self._obj_map:
            raise KeyError("'{}' already registered in registry '{}'".format(name, self._name))
        self._obj_map[name] = obj

    def get(self, name):
        if name not in self._obj_map:
            raise KeyError("'{}' not found in registry '{}'. Known: {}".format(
                name, self._name, sorted(self._obj_map.keys())))
        return self._obj_map[name]

    def __contains__(self, name):
        return name in self._obj_map

    def keys(self):
        return sorted(self._obj_map.keys())


MODEL_REGISTRY = Registry("MODEL")
ENCODER_REGISTRY = Registry("ENCODER")
GEO_MODEL_REGISTRY = Registry("GEO_MODEL")
RADIANCE_MODEL_REGISTRY = Registry("RADIANCE_MODEL")
BOUND_REGISTRY = Registry("BOUND")
DATASET_REGISTRY = Registry("DATASET")
