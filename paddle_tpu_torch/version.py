"""paddle.version parity (ref: python/paddle/version.py, generated at
build time), the port's counterpart of ``paddle_tpu/version.py``: the
port carries the JAX package's version, whose surface it mirrors.
``paddle_tpu_torch.__version__`` reads from here."""

full_version = "0.2.0"
major, minor, patch = (int(x) for x in full_version.split("."))
rc = 0
istaged = False
commit = "unknown"


def show() -> None:
    print(f"paddle-tpu {full_version} (commit {commit})")
