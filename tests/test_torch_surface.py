"""Every public name of the JAX package has its counterpart in the port, or
a stated reason in ``ALLOWED`` (the differences the port keeps on purpose).

Both packages are read with ``ast``; neither is imported. A JAX module
``recommender_system_tpu/<path>.py`` has its counterpart in
``recommender_system_tpu_torch/<path>.py``. Its public names are its
top-level functions, classes and assignments, and, in a package's
``__init__.py``, what it imports from its own package. A port module offers
those too and every name it imports (an attribute of the module all the
same); ``from . import x`` names a submodule, whose counterpart is the
port's file of that name. A class of the same name in both modules offers
the JAX class's public methods, or a stated reason in ``ALLOWED_METHODS``.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX = ROOT / "recommender_system_tpu"
PORT = ROOT / "recommender_system_tpu_torch"

_LANES = "lane packing is not carried over: the port keeps logical [rows, dim] tables"
_DISPATCH = ("dispatch's trace-time globals: the port picks a kernel by the tensor's "
             "device and shape, and a mesh is the Trainer's, not a global")
_GSPMD = ("a NamedSharding for GSPMD: a rank keeps its rows of a batch "
          "(Mesh.shard_batch) and a replicated parameter is each rank's own")
_NO_STATE = ("no TrainState: the parameters live in the model and the optimizer state "
             "in the Trainer, placed with the parameters (Trainer.sharded)")

# (module, name) -> why the port has no counterpart of that name there
ALLOWED = {
    ("layers/embedding.py", "pack_factor"): "in convert.py, which unpacks JAX stacks",
    ("layers/embedding.py", "unpack_stack"): "in convert.py, which unpacks JAX stacks",
    ("layers/embedding.py", "pack_stack"): _LANES,
    ("layers/embedding.py", "packed_take"): _LANES,
    ("layers/embedding.py", "packed_take_exchange"): _LANES,
    ("ops/embedding_grad.py", "lane_select"): _LANES,
    ("ops/embedding_grad.py", "packed_scatter_add"): _LANES,
    ("ops/embedding_grad.py", "packed_take_fast"): _LANES + " (take_fast is its counterpart)",
    ("ops/embedding_grad.py", "scatter_add_dense"): (
        "the Pallas work-queue entry point: scatter_add_sorted is the kernel's wrapper, "
        "scatter_add_dense_ref its plain version"),
    ("ops/fused_adagrad.py", "split_oversize_sites"): (
        "a v5e gather cliff of the Pallas kernel: the CUDA kernels take a stream whole"),
    ("ops/fused_adagrad.py", "stream_split_rows"): (
        "a v5e gather cliff of the Pallas kernel: the CUDA kernels take a stream whole"),
    ("ops/pallas_kernels.py", "cross_fused"): "in ops/kernels.py (csrc/cross.cu)",
    ("ops/pallas_kernels.py", "fm_fused"): "in ops/kernels.py (csrc/fm.cu)",
    ("ops/pallas_kernels.py", "din_attention_fused"): "in ops/kernels.py (csrc/din_attention.cu)",
    ("ops/pallas_kernels.py", "din_attention_ref"): "in ops/kernels.py, the kernel's plain version",
    ("ops/pallas_kernels.py", "NEG_INF"): "a Pallas kernel's mask constant",
    ("parallel/mesh.py", "DATA_AXIS"): "the port's Mesh has data and model sizes, no axis names",
    ("parallel/mesh.py", "MODEL_AXIS"): "the port's Mesh has data and model sizes, no axis names",
    ("parallel/mesh.py", "replicated"): _GSPMD,
    ("parallel/mesh.py", "batch_sharding"): _GSPMD,
    ("parallel/mesh.py", "shard_batch"): _GSPMD + " (Mesh.shard_batch is the method)",
    ("parallel/mesh.py", "shard_state"): _NO_STATE,
    ("parallel/mesh.py", "state_shardings"): _NO_STATE,
    ("parallel/__init__.py", "batch_sharding"): _GSPMD,
    ("parallel/__init__.py", "shard_batch"): _GSPMD + " (Mesh.shard_batch is the method)",
    ("parallel/__init__.py", "shard_state"): _NO_STATE,
    ("parallel/__init__.py", "state_shardings"): _NO_STATE,
    ("parallel/launch.py", "global_batch_from_local"): (
        "torch has no global array: a rank keeps its rows (host_batch_slice)"),
    ("training/harness.py", "TrainState"): _NO_STATE,
    ("training/harness.py", "flax_unfreeze"): "a Flax FrozenDict helper",
    ("training/__init__.py", "TrainState"): _NO_STATE,
    ("utils/datasets.py", "REFERENCE_DATA_DIR"): (
        "the port's loaders take the data's path from the caller"),
}
ALLOWED.update({("ops/dispatch.py", name): _DISPATCH for name in (
    "fast_scatter", "fused_opt_mode", "interpret_mode", "lookup_capacity", "lookup_mesh",
    "mesh_mode", "on_tpu", "set_fused_opt_mode", "set_lookup_mesh", "set_mesh_mode",
    "use_pallas")})
_FLAX_SETUP = "Flax's setup(): a torch module builds its submodules in __init__"
# (module, class, method) -> why the port's class of that name lacks it
ALLOWED_METHODS = {
    ("layers/embedding.py", "EmbeddingCollection", "setup"): _FLAX_SETUP,
    ("models/dssm.py", "DSSM", "setup"): _FLAX_SETUP,
    ("models/transformer.py", "Transformer", "setup"): _FLAX_SETUP,
}
# JAX modules with no port file of the same path
ALLOWED_MODULES = {
    "ops/pallas_kernels.py": "the Pallas kernels' CUDA counterparts are csrc/*.cu, "
                             "bound in ops/kernels.py",
}


def _names(path: pathlib.Path, port: bool):
    """(public names, submodules) of a module, read with ``ast``."""
    tree = ast.parse(path.read_text())
    names, submodules = set(), set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
        elif isinstance(node, ast.ImportFrom) and node.level and node.module is None:
            submodules.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.ImportFrom, ast.Import)) and (
                port or (getattr(node, "level", 0) and path.name == "__init__.py")):
            names.update((a.asname or a.name).split(".")[0] for a in node.names)
    return {n for n in names if not n.startswith("_")}, submodules


def _methods(path: pathlib.Path):
    """{class: its public methods} of a module's top-level classes."""
    return {node.name: {m.name for m in node.body
                        if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and not m.name.startswith("_")}
            for node in ast.parse(path.read_text()).body if isinstance(node, ast.ClassDef)}


def _jax_modules():
    return sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


@pytest.mark.parametrize("module", _jax_modules())
def test_every_public_jax_name_has_a_counterpart(module):
    jax_names, jax_subs = _names(JAX / module, port=False)
    port_file = PORT / module
    if not port_file.exists():
        assert module in ALLOWED_MODULES, f"no port module {module}"
        missing = {n for n in jax_names if (module, n) not in ALLOWED}
        assert not missing, f"{module}: {sorted(missing)} have no counterpart or reason"
        return
    port_names, port_subs = _names(port_file, port=True)
    missing = sorted(n for n in jax_names - port_names if (module, n) not in ALLOWED)
    assert not missing, f"{module}: {missing} have no counterpart in the port"
    package = port_file.parent
    for sub in jax_subs:
        assert (package / f"{sub}.py").exists() or (package / sub / "__init__.py").exists(), \
            f"{module}: no port submodule {sub}"


def test_every_allowance_names_a_jax_name_the_port_lacks():
    """The allowlist holds only what it must: each entry is a public JAX
    name that the port's module of that path lacks, with a reason."""
    for (module, name), reason in ALLOWED.items():
        assert reason.strip(), (module, name)
        jax_names, _ = _names(JAX / module, port=False)
        assert name in jax_names, (module, name)
        port_file = PORT / module
        if port_file.exists():
            assert name not in _names(port_file, port=True)[0], (module, name)
    for module in ALLOWED_MODULES:
        assert (JAX / module).exists() and not (PORT / module).exists(), module


def test_surface_covers_this_slice():
    """The names this slice ports are the port's own, not allowances."""
    for module, name in [("models/lr.py", "fit_logistic_regression"),
                         ("models/lr.py", "STOP_GRAD"), ("models/cf.py", "ItemCF"),
                         ("models/cf.py", "top_k"), ("models/mf.py", "recommend"),
                         ("utils/datasets.py", "load_logireg"),
                         ("utils/vocab.py", "encode_batch"),
                         ("utils/benchmark.py", "bench_train_step"),
                         ("parallel/mesh.py", "COLUMN_SHARD_MIN_DIM"),
                         ("parallel/mesh.py", "wide_table_sharding"),
                         ("parallel/mesh.py", "expert_sharding"),
                         ("parallel/mesh.py", "is_expert_path"),
                         ("parallel/mesh.py", "param_shardings")]:
        assert (module, name) not in ALLOWED
        assert name in _names(PORT / module, port=True)[0], (module, name)


def _shared_class_modules():
    return [m for m in _jax_modules() if (PORT / m).exists()
            and set(_methods(JAX / m)) & set(_methods(PORT / m))]


@pytest.mark.parametrize("module", _shared_class_modules())
def test_every_public_jax_method_has_a_counterpart(module):
    """A class the port keeps under the JAX name offers each public method
    of the JAX class (``Trainer.make_multi_step`` among them)."""
    jax_classes, port_classes = _methods(JAX / module), _methods(PORT / module)
    missing = sorted((cls, name) for cls in set(jax_classes) & set(port_classes)
                     for name in jax_classes[cls] - port_classes[cls]
                     if (module, cls, name) not in ALLOWED_METHODS)
    assert not missing, f"{module}: {missing} have no counterpart in the port"


def test_every_method_allowance_names_a_jax_method_the_port_lacks():
    for (module, cls, name), reason in ALLOWED_METHODS.items():
        assert reason.strip(), (module, cls, name)
        assert name in _methods(JAX / module)[cls], (module, cls, name)
        assert name not in _methods(PORT / module)[cls], (module, cls, name)


def test_surface_covers_the_k_step_calls():
    """The methods this slice ports are the port's own, not allowances."""
    for name in ("make_multi_step", "make_multi_step_packed"):
        assert ("training/harness.py", "Trainer", name) not in ALLOWED_METHODS
        assert name in _methods(PORT / "training/harness.py")["Trainer"]
