"""Every public name and parameter of the JAX package has its counterpart in
the port, module by module (``jax_utils/`` ↔ ``torch_utils/``), unless it is
one of the deliberate divergences in :data:`DIVERGENCES`, the same list
``ROADMAP.md`` keeps.

Both packages are read with ``ast``, nothing is imported. A module's public
surface is what it defines without a leading underscore:

- functions with their parameters, and classes with their methods (and
  their parameters), properties, class attributes and the ``self.<name>``
  attributes that ``__init__`` sets;
- module-level assignments, leaving out loggers and the fallbacks of a
  ``try`` / ``except ImportError``.

On the port's side a name may also be imported into the module, or be an
instance attribute set by any method. A JAX parameter the port lacks is a
miss (``*args`` / ``**kwargs`` stand for no name); where the port holds a
callable in an attribute, its parameters are not read. Private names are
out of scope. The packages' lazy top-level exports are compared too.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_ROOT = os.path.join(REPO, "petastorm_tpu")
PORT_ROOT = os.path.join(REPO, "petastorm_tpu_torch")

_FUNCTIONAL = ("the PyTorch idiom: the functional init / apply / train-step of the JAX "
               "models are nn.Modules, rng is a seed for a torch.Generator")
_GROUP = "a torch.distributed process group stands where the JAX code has a mesh and axis names"
_LOADERS = "the make_*jax_dataloader names, whose torch counterparts exist"

#: ``(module, name)`` or ``(module, name, parameter)`` → why the port has
#: no counterpart. ``module`` is the JAX module's path in its package.
DIVERGENCES = {
    ("models/_shard_compat.py", "*"): "shard_map vma typing, JAX mesh machinery",
    ("jax_utils/sharding.py", "batch_sharding"): "JAX global-array sharding; each DDP rank "
                                                 "keeps its local batch on its own card",
    ("jax_utils/sharding.py", "local_data_to_global_array"): "JAX global arrays; each DDP "
                                                             "rank keeps its local batch",
    ("models/sequence_model.py", "seq_param_partition_specs"): "JAX mesh PartitionSpecs",
    ("jax_utils/device_stage.py", "DeviceStage.__init__", "donate"): "JAX buffer donation",
    ("jax_utils/device_stage.py", "DeviceStage.host_reference"): "the JAX stage's numpy "
                                                                 "reference of its XLA kernel",
    ("jax_utils/checkpoint.py", "restore_training_state", "abstract_arrays"):
        "orbax abstract arrays; the port restores one torch.save file",
    ("jax_utils/loader.py", "make_jax_dataloader"): _LOADERS,
    ("jax_utils/loader.py", "JaxDataLoader"): _LOADERS,
    ("jax_utils/packing.py", "make_packed_jax_dataloader"): _LOADERS,
    ("spark/dataset_converter.py", "DatasetConverter.make_jax_dataloader"): _LOADERS,
    ("__init__.py", "make_jax_dataloader"): _LOADERS,
    ("models/image_classifier.py", "init_params"): _FUNCTIONAL,
    ("models/image_classifier.py", "apply_model"): _FUNCTIONAL,
    ("models/image_classifier.py", "make_train_step"): _FUNCTIONAL,
    ("models/tabular_dlrm.py", "init_dlrm_params"): _FUNCTIONAL,
    ("models/tabular_dlrm.py", "apply_dlrm"): _FUNCTIONAL,
    ("models/moe.py", "init_moe_params", "rng"): _FUNCTIONAL,
    ("models/pipeline.py", "init_pipeline_params", "rng"): _FUNCTIONAL,
    ("models/sequence_model.py", "init_seq_params", "rng"): _FUNCTIONAL,
    ("models/sequence_model.py", "apply_seq_model", "params"): _FUNCTIONAL,
    ("models/sequence_model.py", "apply_seq_model", "num_heads"): _FUNCTIONAL,
    ("models/sequence_model.py", "make_seq_train_step", "num_heads"): _FUNCTIONAL,
    ("models/sequence_model.py", "apply_seq_model", "mesh"): _GROUP,
    ("models/sequence_model.py", "apply_seq_model", "attn_axis"): _GROUP,
    ("models/sequence_model.py", "make_seq_train_step", "mesh"): _GROUP,
    ("models/sequence_model.py", "make_seq_train_step", "attn_axis"): _GROUP,
    ("models/sequence_model.py", "ring_attention", "mesh"): _GROUP,
    ("models/sequence_model.py", "ring_attention", "axis_name"): _GROUP,
    ("models/sequence_model.py", "ring_attention", "batch_axis"): _GROUP,
    ("models/sequence_model.py", "ulysses_attention", "mesh"): _GROUP,
    ("models/sequence_model.py", "ulysses_attention", "axis_name"): _GROUP,
    ("models/sequence_model.py", "ulysses_attention", "batch_axis"): _GROUP,
    ("models/sequence_model.py", "ring_attention_block", "axis_name"): _GROUP,
    ("models/sequence_model.py", "ring_attention_block", "axis_size"): _GROUP,
    ("models/sequence_model.py", "ring_attention_block", "varying_axes"): _GROUP,
    ("models/sequence_model.py", "ulysses_attention_block", "axis_name"): _GROUP,
    ("models/sequence_model.py", "ulysses_attention_block", "axis_size"): _GROUP,
    ("benchmark/throughput.py", "reader_throughput", "apply_jax_loader"):
        "the benchmark's --jax-* flags are --torch-*",
    ("benchmark/throughput.py", "reader_throughput", "jax_batch_size"):
        "the benchmark's --jax-* flags are --torch-*",
    ("reader_impl/delivery_tracker.py", "PiecePayload"):
        "each worker publishes (item_key, payload) pairs",
}


def _is_logger(value):
    func = value.func if isinstance(value, ast.Call) else None
    name = getattr(func, "attr", getattr(func, "id", ""))
    return name == "getLogger" or name.endswith("_logger")


def _params(fn):
    args = fn.args
    return [a.arg for a in args.posonlyargs + args.args + args.kwonlyargs]


class _Surface:
    """The public names of one module: ``{qualified name: parameters or
    None}``, and (for the port) ``{imported name: (module path, name)}``."""

    def __init__(self, path, instance_attrs_of_every_method=False):
        self.names, self.imports = {}, {}
        self._every_method = instance_attrs_of_every_method
        self._walk(ast.parse(open(path, encoding="utf-8").read()).body, "")

    def _walk(self, body, prefix):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if not node.name.startswith("_") or node.name == "__init__":
                    self.names[prefix + node.name] = _params(node)
            elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
                self.names[prefix + node.name] = None
                self._walk(node.body, prefix + node.name + ".")
                self._instance_attrs(node, prefix + node.name + ".")
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                if node.value is not None and _is_logger(node.value):
                    continue
                for target in targets:
                    if isinstance(target, ast.Name) and not target.id.startswith("_"):
                        self.names[prefix + target.id] = None
            elif isinstance(node, ast.ImportFrom) and not prefix:
                for alias in node.names:
                    self.imports[alias.asname or alias.name] = (node.module, alias.name)
            elif isinstance(node, ast.If):
                self._walk(node.body + node.orelse, prefix)
            elif isinstance(node, ast.Try):  # the except branches are fallbacks
                self._walk(node.body + node.orelse + node.finalbody, prefix)

    def _instance_attrs(self, cls, prefix):
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            if not (self._every_method or fn.name == "__init__"):
                continue
            for node in ast.walk(fn):
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target] if isinstance(node, ast.AnnAssign) else [])
                for t in targets:
                    if (isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                            and t.value.id == "self" and not t.attr.startswith("_")):
                        self.names.setdefault(prefix + t.attr, None)


_PORT_CACHE = {}


def _port_surface(module):
    """The port's surface of ``module`` (a dotted name), or None."""
    if module not in _PORT_CACHE:
        rel = module.split(".")[1:]
        candidates = [os.path.join(PORT_ROOT, *rel) + ".py",
                      os.path.join(PORT_ROOT, *rel, "__init__.py")]
        path = next((p for p in candidates if os.path.isfile(p)), None)
        _PORT_CACHE[module] = (_Surface(path, instance_attrs_of_every_method=True)
                               if path else None)
    return _PORT_CACHE[module]


def _port_lookup(module, qualname, depth=0):
    """The port's parameters of ``qualname`` in ``module`` (None for a
    name without parameters); raises KeyError when the port lacks it.
    Follows ``from petastorm_tpu_torch... import`` bindings."""
    surface = _port_surface(module)
    if surface is None:
        raise KeyError(module)
    if qualname in surface.names:
        return surface.names[qualname]
    head, _, rest = qualname.partition(".")
    source = surface.imports.get(head)
    if source and source[0] and source[0].startswith("petastorm_tpu_torch") and depth < 4:
        return _port_lookup(source[0], source[1] + ("." + rest if rest else ""), depth + 1)
    raise KeyError(qualname)


def _jax_modules():
    out = []
    for dirpath, _, files in os.walk(JAX_ROOT):
        for name in files:
            if name.endswith(".py"):
                out.append(os.path.relpath(os.path.join(dirpath, name), JAX_ROOT)
                           .replace(os.sep, "/"))
    return sorted(out)


def _port_module(rel):
    if rel.startswith("jax_utils/"):
        rel = "torch_utils/" + rel[len("jax_utils/"):]
    return "petastorm_tpu_torch." + rel[:-len(".py")].replace("/", ".").replace(
        ".__init__", "")


def _allowed(rel, name, param=None):
    parts = name.split(".")
    keys = [(rel, "*")] + [(rel, ".".join(parts[:i])) for i in range(1, len(parts) + 1)]
    if param is not None:
        keys.append((rel, name, param))
    return any(key in DIVERGENCES for key in keys)


def _misses(rel):
    """The JAX module's public names and parameters the port lacks and
    :data:`DIVERGENCES` does not name."""
    if _allowed(rel, "*"):
        return []
    jax = _Surface(os.path.join(JAX_ROOT, rel))
    module = _port_module(rel)
    if _port_surface(module) is None:
        return [f"{rel}: no port module {module}"]
    misses = []
    for name, params in jax.names.items():
        if _allowed(rel, name):
            continue
        try:
            port_params = _port_lookup(module, name)
        except KeyError:
            misses.append(f"{rel}: {name}")
            continue
        if port_params is None:  # an attribute: its callable's parameters are not read
            continue
        for param in params or ():
            if param not in ("self", "cls") and param not in port_params \
                    and not _allowed(rel, name, param):
                misses.append(f"{rel}: {name}({param}=)")
    return misses


@pytest.mark.parametrize("rel", _jax_modules())
def test_port_has_every_public_jax_name_and_parameter(rel):
    assert _misses(rel) == []


def _lazy_exports(path):
    for node in ast.parse(open(path, encoding="utf-8").read()).body:
        if isinstance(node, ast.Assign) and getattr(node.targets[0], "id", "") == "_LAZY_EXPORTS":
            return {key.value for key in node.value.keys}
    raise AssertionError(f"no _LAZY_EXPORTS in {path}")


def test_top_level_lazy_exports_cover_the_jax_ones():
    jax = _lazy_exports(os.path.join(JAX_ROOT, "__init__.py"))
    port = _lazy_exports(os.path.join(PORT_ROOT, "__init__.py"))
    assert sorted(n for n in jax - port if not _allowed("__init__.py", n)) == []


def test_every_divergence_is_still_one():
    """Each allow-list entry names something the port really lacks, so the
    list cannot outlive what it excuses."""
    stale = []
    for key in DIVERGENCES:
        rel, name = key[0], key[1]
        if rel == "__init__.py":
            present = name in _lazy_exports(os.path.join(PORT_ROOT, "__init__.py"))
        elif name == "*":
            present = _port_surface(_port_module(rel)) is not None
        else:
            try:
                params = _port_lookup(_port_module(rel), name)
                present = len(key) == 2 or (params is not None and key[2] in params)
            except KeyError:
                present = False
        if present:
            stale.append(key)
    assert stale == []
    assert all(reason.strip() for reason in DIVERGENCES.values())
