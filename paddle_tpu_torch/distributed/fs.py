"""Filesystem helpers (the port's counterpart of
``paddle_tpu/distributed/fs.py``; ref: python/paddle/distributed/fleet/utils/fs.py
— ``FS`` interface, ``LocalFS``, ``HDFSClient``/``AFSClient``).

``LocalFS`` is fully functional (os/shutil semantics with the
reference's error types). HDFS/AFS are DECLINED, as in the JAX package:
the reference shells out to a Hadoop client JVM for CTR data lakes; the
port reads posix paths through its checkpoint stack and
``io.DataLoader``. The class stubs keep import-compat and fail loudly
with this pointer.
"""

from __future__ import annotations

import os
import shutil
from typing import List


class ExecuteError(Exception):
    pass


class FSFileExistsError(Exception):
    pass


class FSFileNotExistsError(Exception):
    pass


class FSTimeOut(Exception):
    pass


class FS:
    """Abstract filesystem (ref: fs.py:57)."""

    def ls_dir(self, fs_path):
        raise NotImplementedError

    def is_file(self, fs_path):
        raise NotImplementedError

    def is_dir(self, fs_path):
        raise NotImplementedError

    def is_exist(self, fs_path):
        raise NotImplementedError

    def mkdirs(self, fs_path):
        raise NotImplementedError

    def delete(self, fs_path):
        raise NotImplementedError

    def need_upload_download(self):
        raise NotImplementedError

    def rename(self, fs_src_path, fs_dst_path):
        raise NotImplementedError

    def mv(self, fs_src_path, fs_dst_path, overwrite=False,
           test_exists=False):
        raise NotImplementedError

    def list_dirs(self, fs_path):
        raise NotImplementedError

    def touch(self, fs_path, exist_ok=True):
        raise NotImplementedError

    def cat(self, fs_path=None):
        raise NotImplementedError


class LocalFS(FS):
    """Posix filesystem with the reference's API (ref: fs.py:120)."""

    def ls_dir(self, fs_path):
        """Returns ([dirs], [files]) like the reference."""
        if not self.is_exist(fs_path):
            return [], []
        dirs, files = [], []
        for name in sorted(os.listdir(fs_path)):
            if os.path.isdir(os.path.join(fs_path, name)):
                dirs.append(name)
            else:
                files.append(name)
        return dirs, files

    def is_file(self, fs_path):
        return os.path.isfile(fs_path)

    def is_dir(self, fs_path):
        return os.path.isdir(fs_path)

    def is_exist(self, fs_path):
        return os.path.exists(fs_path)

    def mkdirs(self, fs_path):
        os.makedirs(fs_path, exist_ok=True)

    def delete(self, fs_path):
        if self.is_dir(fs_path):
            shutil.rmtree(fs_path)
        elif self.is_file(fs_path):
            os.remove(fs_path)

    def need_upload_download(self):
        return False

    def rename(self, fs_src_path, fs_dst_path):
        os.rename(fs_src_path, fs_dst_path)

    def mv(self, src_path, dst_path, overwrite=False, test_exists=False):
        if not self.is_exist(src_path):
            raise FSFileNotExistsError(src_path)
        if not overwrite and self.is_exist(dst_path):
            raise FSFileExistsError(dst_path)
        if overwrite and self.is_exist(dst_path):
            self.delete(dst_path)
        os.rename(src_path, dst_path)

    def list_dirs(self, fs_path) -> List[str]:
        return self.ls_dir(fs_path)[0]

    def touch(self, fs_path, exist_ok=True):
        if self.is_exist(fs_path):
            if not exist_ok:
                raise FSFileExistsError(fs_path)
            os.utime(fs_path, None)
            return
        open(fs_path, "a").close()

    def cat(self, fs_path=None):
        with open(fs_path, "rb") as f:
            return f.read().decode("utf-8", errors="replace")


_DECLINED = (
    "{name} is deliberately not ported: the reference shells out to a "
    "Hadoop/AFS client JVM for CTR data lakes "
    "(reference python/paddle/distributed/fleet/utils/fs.py:{line}); "
    "the checkpoint stack and io.DataLoader read posix paths — use "
    "LocalFS, and a mounted filesystem for remote data.")


class HDFSClient(FS):
    """DECLINED — decision record in the module docstring."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(_DECLINED.format(name="HDFSClient",
                                                   line=290))


class AFSClient(FS):
    """DECLINED — decision record in the module docstring."""

    def __init__(self, *a, **kw):
        raise NotImplementedError(_DECLINED.format(name="AFSClient",
                                                   line=1100))
