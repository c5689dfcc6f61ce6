"""The port's surface held to the JAX package's, read from the sources with
ast (neither package is imported; the port's trainer CLI, which registers
its loss-weight flags in a loop, is asked for its parser, which needs only
argparse):

- every module of music_generation_tpu/ has a module at the same path in
  music_generation_tpu_torch/;
- every public module-level function and class of a JAX module, and every
  public method of a public class there, has a same-named twin in the
  port's module (defined, imported or inherited from a class of the same
  module);
- every name of a JAX package's ``__all__`` is in the port's ``__all__``;
- every flag and positional argument of each JAX entry point is taken by
  the port's, and the port's own flags are the JAX flags.

EXCEPTIONS holds every deliberate difference: the JAX name, or a port-only
flag, and the port's counterpart or why there is none. Each entry must
still name a difference that exists.
"""

import ast
import functools
import importlib.util
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX = ROOT / "music_generation_tpu"
PORT = ROOT / "music_generation_tpu_torch"

_SETUP = "__init__: flax builds the submodules in setup"
_JIT = "none: the port runs eagerly, so it keeps no jit cache"
EXCEPTIONS = {
    # "module:name" of the JAX package -> the port's counterpart
    "ops/monotonic_align.py:maximum_path_pallas":
        "maximum_path, which launches csrc/monotonic_align.cu (CUDA C++) "
        "for CUDA tensors",
    "ops/monotonic_align.py:maximum_path_jax": "maximum_path_torch",
    "ops/monotonic_align.py:maximum_path_numpy":
        "maximum_path_torch, the port's oracle",
    "ops/monotonic_align.py:_auto_platform": "device.resolve_device",
    "train/trainer.py:make_optimizer":
        "train.trainer.Optimizer (optax's chain in torch)",
    "compat/torch_import.py:visinger_params_from_torch":
        "compat.torch_import.visinger_state_dict_from_torch (the port keeps "
        "torch state_dicts)",
    "pipeline/synthesis.py:SVSSynthesizer._compiled": _JIT,
    "pipeline/synthesis.py:SVSSynthesizer._compiled_int16": _JIT,
    "pipeline/synthesis.py:SVSSynthesizer._compiled_hidden": _JIT,
    "pipeline/synthesis.py:SVSSynthesizer._compiled_stream_window": _JIT,
    "pipeline/fused.py:FusedSongSynthesizer._compiled": _JIT,
    "models/melody/api.py:MelodyGenerator._beam_impl": _JIT,
    "models/melody/api.py:MelodyGenerator._duration_impl": _JIT,
    "models/melody/api.py:MelodyGenerator._song_impl": _JIT,
    "models/duration.py:StochasticDurationPredictor.setup": _SETUP,
    "models/lyrics/gpt2.py:GPT2.setup": _SETUP,
    "models/lyrics/gpt2.py:GPT2Block.setup": _SETUP,
    "models/lyrics/t5.py:T5.setup": _SETUP,
    "models/lyrics/t5.py:T5Attention.setup": _SETUP,
    "models/lyrics/t5.py:T5DecoderLayer.setup": _SETUP,
    "models/lyrics/t5.py:T5EncoderLayer.setup": _SETUP,
    "models/melody/seq2seq.py:Seq2SeqDecoder.setup": _SETUP,
    "models/melody/seq2seq.py:Seq2SeqEncoder.setup": _SETUP,
    "models/melody/seq2seq.py:Seq2SeqModel.setup": _SETUP,
    "models/melody/transformer.py:MelodyTransformer.setup": _SETUP,
    "models/melody/transformer.py:SDPDurationModel.setup": _SETUP,
    "models/svs/visinger.py:VISinger.setup": _SETUP,
    # "entry point:flag" of the port alone
    **{f"{entry}:--device": "the port's: a torch device, cuda unless given"
       for entry in ("serve/app.py", "serve/melody_service.py",
                     "pipeline/__main__.py", "train/__main__.py",
                     "train/seq.py")},
}

ENTRY_POINTS = ("serve/app.py", "serve/proxy.py", "serve/melody_service.py",
                "pipeline/__main__.py", "train/__main__.py", "train/seq.py",
                "train/dataset.py", "train/toydata.py")
MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))
PACKAGES = [m for m in MODULES if m.endswith("__init__.py")]


@functools.lru_cache(maxsize=None)
def _tree(path: Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


def _classes(tree: ast.Module) -> dict:
    return {n.name: n for n in tree.body if isinstance(n, ast.ClassDef)}


def _methods(cls: ast.ClassDef) -> set:
    return {n.name for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def jax_names(path: Path) -> set:
    """Public functions and classes, and public methods of public classes
    ("Class.method"), defined at the top of a module."""
    out = set()
    for node in _tree(path).body:
        if getattr(node, "name", "_").startswith("_"):
            continue
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.add(node.name)
        elif isinstance(node, ast.ClassDef):
            out.add(node.name)
            out.update(f"{node.name}.{m}" for m in _methods(node)
                       if not m.startswith("_"))
    return out


def defined_names(path: Path) -> set:
    """Every name a module defines or imports at its top, and every method
    of its classes, also those inherited from a class of the module."""
    tree = _tree(path)
    out = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            out.update((a.asname or a.name).split(".")[0]
                       for a in node.names)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            out.update(t.id for t in targets if isinstance(t, ast.Name))
    classes = _classes(tree)

    def methods(name, seen=()):
        cls = classes.get(name)
        if cls is None or name in seen:
            return set()
        found = _methods(cls)
        for base in cls.bases:
            if isinstance(base, ast.Name):
                found |= methods(base.id, seen + (name,))
        return found
    for name in classes:
        out.update(f"{name}.{m}" for m in methods(name))
    return out


def dunder_all(path: Path):
    for node in _tree(path).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == "__all__" for t in node.targets):
            return set(ast.literal_eval(node.value))
    return None


def cli_arguments(path: Path) -> tuple[set, list]:
    """(flags, positional names) of every literal add_argument call."""
    flags, positionals = set(), []
    for node in ast.walk(_tree(path)):
        if isinstance(node, ast.Call) and \
                getattr(node.func, "attr", None) == "add_argument":
            names = [a.value for a in node.args
                     if isinstance(a, ast.Constant) and isinstance(a.value,
                                                                   str)]
            flags.update(n for n in names if n.startswith("-"))
            positionals += [n for n in names if not n.startswith("-")]
    return flags, positionals


def port_cli_arguments(entry: str) -> tuple[set, list]:
    flags, positionals = cli_arguments(PORT / entry)
    if entry == "train/__main__.py":
        spec = importlib.util.spec_from_file_location(
            "_port_train_cli", PORT / entry)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)  # stdlib imports only
        flags |= set(module._parser()._option_string_actions)
        flags -= {"-h", "--help"}
    return flags, positionals


def _missing(rel: str, names: set) -> list:
    return sorted(n for n in names if f"{rel}:{n}" not in EXCEPTIONS)


@pytest.mark.parametrize("rel", MODULES)
def test_module_has_a_twin_with_every_public_name(rel):
    port = PORT / rel
    assert port.exists(), f"no {port.relative_to(ROOT)} for {rel}"
    missing = _missing(rel, jax_names(JAX / rel) - defined_names(port))
    assert not missing, f"{rel}: the port lacks {missing}"


@pytest.mark.parametrize("rel", PACKAGES)
def test_package_exports(rel):
    want = dunder_all(JAX / rel)
    if want is None:
        return
    got = dunder_all(PORT / rel)
    assert got is not None, f"the port's {rel} has no __all__"
    package = rel.rpartition("/")[0]
    excused = {key.rpartition(":")[2] for key in EXCEPTIONS
               if key.startswith(package + "/")}
    missing = sorted(want - got - excused)
    assert not missing, f"the port's {rel} does not export {missing}"


@pytest.mark.parametrize("entry", ENTRY_POINTS)
def test_entry_point_takes_every_flag(entry):
    want_flags, want_pos = cli_arguments(JAX / entry)
    got_flags, got_pos = port_cli_arguments(entry)
    assert want_flags, f"no flags read from {entry}"
    assert got_pos == want_pos
    missing = sorted(want_flags - got_flags)
    assert not missing, f"the port's {entry} lacks {missing}"
    extra = _missing(entry, got_flags - want_flags)
    assert not extra, f"the port's {entry} adds {extra} (record them in " \
                      f"EXCEPTIONS)"


def test_every_exception_is_still_a_difference():
    """An entry whose JAX name gained a twin, or whose port-only flag is
    gone or now in the JAX package too, must go: the dict stays the list
    of what differs."""
    stale = []
    for key in EXCEPTIONS:
        rel, _, name = key.partition(":")
        if name.startswith("-"):
            flags = port_cli_arguments(rel)[0]
            if name not in flags or name in cli_arguments(JAX / rel)[0]:
                stale.append(key)
            continue
        cls, _, method = name.rpartition(".")
        tree = _tree(JAX / rel)
        jax_has = (method in _methods(_classes(tree)[cls]) if cls
                   else any(getattr(n, "name", None) == name
                            for n in tree.body))
        if not jax_has or name in defined_names(PORT / rel):
            stale.append(key)
    assert not stale, f"stale EXCEPTIONS entries: {stale}"
