"""The port's public names against the JAX package's, by reading both
trees' source (no import of either, except in the last two cases).

Every public top-level function, class and module constant of every JAX
module, every name a JAX ``__init__`` re-exports, and every public
method or class attribute of a public JAX class (``_BaseModel``
included) has a counterpart: the same name in the port's module of the
same path, or the entry of :data:`RENAMES` / :data:`MODULES` that names
where the port keeps it and why. A second case holds every entry of the
two tables to a counterpart that exists and to a JAX name the port does
not carry under the same path, so neither table goes stale. A third
imports each port subpackage and resolves its re-exports; a fourth
checks in a fresh interpreter that importing ``ops``, ``models`` and
``samplers`` loads no kernel module.
"""

import ast
import functools
import importlib
import os
import pathlib
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
JAX = REPO / "lumfuncmcmc_tpu"
PORT = REPO / "lumfuncmcmc_tpu_torch"

_CUDA = "the hand kernels are CUDA, not Pallas"
_KEYS = "the port draws from a torch.Generator, not a JAX key"
# "jax/module.py:name" -> ("port/module.py:name", why the name differs)
RENAMES = {
    "parallel/sharding.py:make_pallas_lnprob_sharded":
        ("parallel/sharding.py:make_cuda_lnprob_sharded", _CUDA),
    "parallel/sharding.py:make_pallas_lnprob_stream_sharded":
        ("parallel/sharding.py:make_cuda_lnprob_stream_sharded", _CUDA),
    "parallel/sharding.py:make_pallas_vg_stream_sharded":
        ("parallel/sharding.py:make_cuda_vg_stream_sharded", _CUDA),
    "parallel/sharding.py:continue_nuts_keys_sharded":
        ("parallel/sharding.py:continue_nuts_sharded_with", _KEYS),
    "parallel/sharding.py:continue_nuts_keys_stream_sharded":
        ("parallel/sharding.py:continue_nuts_stream_sharded", _KEYS),
    "samplers/nuts.py:sampling_keys":
        ("samplers/nuts.py:block_draw", _KEYS),
    "samplers/nuts.py:continue_nuts_keys":
        ("samplers/nuts.py:continue_nuts_with", _KEYS),
    "samplers/nuts.py:RNG_PROTOCOL":
        ("models/ensemble_driver.py:PROTOCOL",
         "the checkpoints' generator protocol tag lives with the drivers"),
    "ops/pallas_lnlike.py:BLK_W":
        ("ops/cuda_lnlike.py:VG_TILES",
         "a block's walker tile is picked per call, not fixed"),
    "ops/pallas_lnlike.py:LANES":
        ("ops/cuda_lnlike.py:THREADS", "a CUDA block has threads, not lanes"),
    "ops/pallas_lnlike.py:PallasGridData":
        ("ops/cuda_lnlike.py:CudaGridData", _CUDA),
    "ops/pallas_lnlike.py:PallasZData":
        ("ops/cuda_lnlike.py:CudaZData", _CUDA),
    "ops/pallas_lnlike.py:PallasZ2Data":
        ("ops/cuda_lnlike.py:CudaZData", "the z kernels take one layout"),
    "ops/pallas_lnlike.py:prepare_pallas_data":
        ("ops/cuda_lnlike.py:prepare_cuda_data", _CUDA),
    "ops/pallas_lnlike.py:prepare_pallas_z_data":
        ("ops/cuda_lnlike.py:prepare_cuda_z_data", _CUDA),
    "ops/pallas_lnlike.py:prepare_pallas_z2_data":
        ("ops/cuda_lnlike.py:prepare_cuda_z_data",
         "the z kernels take one layout"),
    "ops/pallas_lnlike.py:prepare_stream_shard_data":
        ("ops/cuda_lnlike.py:prepare_cuda_stream_data",
         "one streaming layout takes the shard count"),
    "ops/pallas_lnlike.py:free_comp_over_vmem":
        ("ops/cuda_lnlike.py:STREAM_MIN_SOURCES",
         "the streaming route starts at a catalog size, not a VMEM size"),
    "ops/pallas_lnlike.py:make_pallas_lnlike":
        ("ops/cuda_lnlike.py:make_cuda_prior_like",
         "the likelihood comes with its prior, for every family"),
    "ops/pallas_lnlike.py:make_pallas_lnlike_z":
        ("ops/cuda_lnlike.py:make_cuda_prior_like",
         "the likelihood comes with its prior, for every family"),
    "ops/pallas_lnlike.py:make_pallas_lnprob":
        ("ops/cuda_lnlike.py:make_cuda_lnprob", _CUDA),
    "ops/pallas_lnlike.py:make_pallas_lnprob_z":
        ("ops/cuda_lnlike.py:make_cuda_lnprob_z", _CUDA),
    "ops/pallas_lnlike.py:make_pallas_lnprob_h":
        ("ops/cuda_lnlike.py:make_cuda_lnprob_h", _CUDA),
    "ops/pallas_lnlike.py:make_pallas_lnprob_and_grad":
        ("ops/cuda_lnlike.py:make_cuda_lnprob_and_grad", _CUDA),
    "ops/pallas_lnlike.py:make_stream_shard_batched":
        ("parallel/sharding.py:make_cuda_lnprob_stream_sharded",
         "the source-sharded streaming lnprob is built on the grid"),
    "ops/pallas_lnlike.py:make_stream_shard_vg":
        ("parallel/sharding.py:make_cuda_vg_stream_sharded",
         "the source-sharded streaming value+gradient is built on the grid"),
}
# JAX module -> (the port modules that hold its names, why), for the
# modules the port has under another path
MODULES = {
    "ops/pallas_lnlike.py":
        (("ops/cuda_lnlike.py", "ops/_build.py"),
         "CUDA kernels behind ctypes, built by nvcc at first use"),
    "ops/pallas_roofline.py":
        (("ops/roofline.py",), _CUDA),
}


def _targets(node):
    if isinstance(node, ast.Assign):
        return [t.id for t in node.targets if isinstance(t, ast.Name)]
    if isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
        return [node.target.id]
    return []


@functools.lru_cache(maxsize=None)
def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def defined(path, imports=True):
    """Names a module binds at top level: defs, classes, assignments and,
    with ``imports``, ``from ... import`` names."""
    out = set()
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif imports and isinstance(node, ast.ImportFrom):
            out.update(a.asname or a.name for a in node.names)
        out.update(_targets(node))
    return out


def public(path):
    """A JAX module's public names: its own definitions, and in an
    ``__init__`` its re-exports too."""
    names = defined(path, imports=path.name == "__init__.py")
    return {n for n in names if not n.startswith("_")}


@functools.lru_cache(maxsize=None)
def classes(root):
    """{(module path, class name): (base names, members)} over every
    module of a tree."""
    out = {}
    for path in root.rglob("*.py"):
        for node in _tree(path).body:
            if isinstance(node, ast.ClassDef):
                members = set()
                for n in node.body:
                    if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        members.add(n.name)
                    members.update(_targets(n))
                bases = [b.id for b in node.bases if isinstance(b, ast.Name)]
                out[(path, node.name)] = (bases, members)
    return out


def members(table, path, name, seen=()):
    """A class's members with those of its bases (looked up in the same
    module first, then anywhere in the tree)."""
    bases, own = table[(path, name)]
    out = set(own)
    for b in bases:
        key = (path, b) if (path, b) in table else next(
            (k for k in table if k[1] == b), None)
        if key is not None and key not in seen:
            out |= members(table, key[0], b, seen + (key,))
    return out


JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _port_paths(rel):
    if (PORT / rel).exists():
        return (rel,)
    return MODULES.get(rel, ((),))[0]


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_every_public_jax_name_has_a_port_counterpart(rel):
    paths = _port_paths(rel)
    assert paths, f"{rel}: no port module of that path and no MODULES entry"
    have = set().union(*(defined(PORT / p) for p in paths))
    missing = sorted(n for n in public(JAX / rel)
                     if n not in have and f"{rel}:{n}" not in RENAMES)
    assert not missing, f"{rel}: the port lacks {missing}"

    jcls, pcls = classes(JAX), classes(PORT)
    for (path, name) in jcls:
        if path != JAX / rel or (name.startswith("_")
                                 and name != "_BaseModel"):
            continue
        port = [p for p in paths if (PORT / p, name) in pcls]
        if not port:
            assert f"{rel}:{name}" in RENAMES, f"{rel}: class {name}"
            continue
        want = {m for m in members(jcls, path, name)
                if not m.startswith("_")}
        got = members(pcls, PORT / port[0], name)
        assert want <= got, f"{rel}: {name} lacks {sorted(want - got)}"


def test_every_rename_names_a_counterpart_that_exists():
    for jax_entry, (port_entry, why) in RENAMES.items():
        rel, name = jax_entry.split(":")
        assert why and name in public(JAX / rel), jax_entry
        # a rename only for what the port does not carry under the name
        assert name not in set().union(*(
            defined(PORT / p) for p in _port_paths(rel))), jax_entry
        prel, pname = port_entry.split(":")
        assert (PORT / prel).exists(), port_entry
        assert pname in defined(PORT / prel, imports=False), port_entry
    for rel, (paths, why) in MODULES.items():
        assert why and (JAX / rel).exists() and not (PORT / rel).exists()
        for p in paths:
            assert (PORT / p).exists(), p


PACKAGES = sorted(str(p.parent.relative_to(REPO)).replace(os.sep, ".")
                  for p in PORT.rglob("__init__.py"))


@pytest.mark.parametrize("pkg", PACKAGES)
def test_port_subpackage_reexports_resolve(pkg):
    mod = importlib.import_module(pkg)
    init = REPO / pkg.replace(".", os.sep) / "__init__.py"
    for node in _tree(init).body:
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            src = importlib.import_module(node.module)
            for a in node.names:
                got = getattr(mod, a.asname or a.name)
                assert got is getattr(src, a.name), (pkg, a.name)
    rel = init.relative_to(PORT)
    if (JAX / rel).exists():
        assert public(JAX / rel) <= set(dir(mod)), pkg


def test_subpackage_imports_load_no_kernel_module():
    code = ("import sys\n"
            "import lumfuncmcmc_tpu_torch.ops, lumfuncmcmc_tpu_torch.models, "
            "lumfuncmcmc_tpu_torch.samplers\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
            "'lumfuncmcmc_tpu') or m.endswith(('.cuda_lnlike', '._build', "
            "'.roofline'))]\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=dict(os.environ, PYTHONPATH=str(REPO)),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
