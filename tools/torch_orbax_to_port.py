#!/usr/bin/env python3
"""Convert a checkpoint step that the JAX package wrote (an orbax step
directory with its manifest) into the port's step format, so that
``paddle_tpu_torch``'s ``CheckpointManager`` and ``Model.fit(resume=)``
restore it.

    python3 tools/torch_orbax_to_port.py CKPT_DIR [--step N] [--out DIR]

The step (by default the newest one with a manifest) is read with
``paddle_tpu.io.checkpoint`` as it is, and its leaves are hashed and
held against the manifest's digests: a step that does not verify is
refused (exit 1) and nothing is written. The tree is then written in
the port's format (``tree.json``, one ``.npy`` a leaf, bf16 as its raw
2-byte payload): into the step directory itself, beside orbax's files,
or, with ``--out``, as step N of the directory DIR together with a copy
of the manifest. Either way the JAX package still restores the step,
the port's digests of the written tree equal the manifest's (checked
before the command returns), and the manifest's ``state`` bundle (step,
epoch, loader cursor, rng key, metrics) carries over unchanged.

This tool imports the JAX package; the port itself never does.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# dtypes a torch tensor holds: such leaves are written as tensors, the
# rest (uint32, ...) as numpy arrays
_TENSOR_DTYPES = {"float16", "float32", "float64", "bfloat16", "int8",
                  "int16", "int32", "int64", "uint8", "bool"}


class Refused(Exception):
    """The step does not verify against its manifest."""


def _host_tree(tree):
    """The restored tree with numpy leaves (bf16 as a torch tensor, the
    port's own bf16 leaf) in the port's leaf kinds."""
    import torch
    if isinstance(tree, dict):
        return {k: _host_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_host_tree(v) for v in tree)
    if tree is None:
        return None
    a = np.asarray(tree)
    name = str(a.dtype)
    if name not in _TENSOR_DTYPES:
        return np.ascontiguousarray(a)
    if name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)
                                .copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, order="C"))


def convert(ckpt_dir: str, step=None, out=None) -> str:
    """Convert step ``step`` (None: the newest manifested one) of the JAX
    checkpoint directory ``ckpt_dir``; returns the port step directory
    written. Raises :class:`Refused` when the step's leaves do not
    match its manifest."""
    from paddle_tpu.io import checkpoint as jckpt
    from paddle_tpu_torch.io import checkpoint as tckpt

    ckpt_dir = os.path.abspath(ckpt_dir)
    if step is None:
        step = jckpt.latest_manifest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no manifested step in {ckpt_dir}")
    step = int(step)
    manifest_path = tckpt._manifest_path(ckpt_dir, step)
    with open(manifest_path) as f:
        manifest = json.load(f)
    digests = manifest.get("digests")
    if not digests:
        raise Refused(f"step {step} has no digests to verify against")
    mgr = jckpt.CheckpointManager(ckpt_dir, async_save=False)
    try:
        try:
            tree = mgr.restore(step, verify=False)
        except Exception as e:  # noqa: BLE001 — unreadable data
            raise Refused(f"step {step} is unreadable: {e!r}") from e
    finally:
        mgr.close()
    got = jckpt.digest_tree(tree)
    bad = sorted(k for k in set(digests) | set(got)
                 if digests.get(k) != got.get(k))
    if bad:
        raise Refused(f"step {step} does not verify against "
                      f"{manifest_path}: {len(bad)} leaves differ "
                      f"({', '.join(bad[:4])})")
    host = _host_tree(tree)
    if tckpt.digest_tree(host) != digests:
        raise AssertionError("the port's digests of the converted tree "
                             "differ from the manifest's")
    src_dir = os.path.join(ckpt_dir, str(step))
    if out is None:
        dest = src_dir
        # the port's files beside orbax's: written in a scratch dir,
        # moved in, tree.json last (the port reads a step by it)
        with tempfile.TemporaryDirectory(dir=ckpt_dir,
                                         prefix=".port-convert-") as tmp:
            staged = os.path.join(tmp, "step")
            tckpt._write_step_dir(staged, host)
            names = sorted(os.listdir(staged), key=lambda n: (
                n == tckpt._TREE_FILE, n))
            for name in names:
                os.replace(os.path.join(staged, name),
                           os.path.join(dest, name))
    else:
        out = os.path.abspath(out)
        os.makedirs(out, exist_ok=True)
        dest = os.path.join(out, str(step))
        tckpt._write_step_dir(dest, host)
        shutil.copyfile(manifest_path, tckpt._manifest_path(out, step))
        marker = os.path.join(out, tckpt._ERA_MARKER)
        if not os.path.exists(marker):
            with open(marker, "w") as f:
                json.dump({"first_step": step}, f)
    back = tckpt._read_step_dir(dest)
    if tckpt.digest_tree(back) != digests:
        raise AssertionError(f"{dest}: the written tree does not verify")
    return dest


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("ckpt_dir", help="a JAX-package checkpoint directory")
    ap.add_argument("--step", type=int, default=None,
                    help="the step to convert (default: the newest "
                         "manifested step)")
    ap.add_argument("--out", default=None,
                    help="write step N of this directory instead of "
                         "beside the orbax files")
    args = ap.parse_args(argv)
    try:
        dest = convert(args.ckpt_dir, args.step, args.out)
    except Refused as e:
        print(f"refused: {e}", file=sys.stderr)
        return 1
    print(dest)
    return 0


if __name__ == "__main__":
    sys.exit(main())
