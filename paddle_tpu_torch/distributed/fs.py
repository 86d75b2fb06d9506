"""Fleet filesystem utilities — LocalFS + the HDFSClient interface (port
of paddle_tpu/distributed/fs.py).

Parity: python/paddle/fluid/incubate/fleet/utils/hdfs.py
(HDFSClient shelling out to `hadoop fs`) and the fleet checkpoint/model
save flows built on it. The portable contract here is the `FS` interface
with a fully working LocalFS (what localhost clusters and tests use);
HDFSClient keeps the reference's method surface and delegates to the
`hadoop` binary when one exists, raising a clear error otherwise.

split_files is the reference's deterministic file-to-trainer assignment
(hdfs.py:396), used by dataset sharding.
"""

import os
import shutil
import subprocess

__all__ = ["FS", "LocalFS", "HDFSClient", "split_files"]


class FS:
    """Interface: the subset of hdfs.py's HDFSClient the fleet flows use."""

    def is_exist(self, path):
        raise NotImplementedError

    def is_dir(self, path):
        raise NotImplementedError

    def is_file(self, path):
        raise NotImplementedError

    def ls(self, path):
        raise NotImplementedError

    def makedirs(self, path):
        raise NotImplementedError

    def delete(self, path):
        raise NotImplementedError

    def rename(self, src, dst, overwrite=False):
        raise NotImplementedError

    def cat(self, path):
        raise NotImplementedError

    def upload(self, dest, local):
        raise NotImplementedError

    def download(self, src, local):
        raise NotImplementedError


class LocalFS(FS):
    """Local filesystem implementation of the FS contract."""

    def is_exist(self, path):
        return os.path.exists(path)

    def is_dir(self, path):
        return os.path.isdir(path)

    def is_file(self, path):
        return os.path.isfile(path)

    def ls(self, path):
        return sorted(os.listdir(path))

    def makedirs(self, path):
        os.makedirs(path, exist_ok=True)

    def delete(self, path):
        if os.path.isdir(path):
            shutil.rmtree(path)
        elif os.path.exists(path):
            os.remove(path)

    def rename(self, src, dst, overwrite=False):
        if os.path.exists(dst):
            if not overwrite:
                raise FileExistsError(dst)
            self.delete(dst)
        os.replace(src, dst)

    def cat(self, path):
        with open(path, "r") as f:
            return f.read()

    def upload(self, dest, local):
        if os.path.isdir(local):
            shutil.copytree(local, dest, dirs_exist_ok=True)
        else:
            os.makedirs(os.path.dirname(dest) or ".", exist_ok=True)
            shutil.copy2(local, dest)

    def download(self, src, local):
        self.upload(local, src)


class HDFSClient(FS):
    """hdfs.py:45 surface — shells out to `hadoop fs` like the
    reference. Constructing it without a hadoop binary raises with a
    clear message (LocalFS is the tested path)."""

    def __init__(self, hadoop_home=None, configs=None):
        self._hadoop = (os.path.join(hadoop_home, "bin", "hadoop")
                        if hadoop_home else shutil.which("hadoop"))
        if not self._hadoop or not os.path.exists(self._hadoop):
            raise RuntimeError(
                "HDFSClient needs a hadoop binary (hadoop_home or PATH); "
                "none found — use LocalFS, or install Hadoop")
        self._configs = [f"-D{k}={v}"
                         for k, v in (configs or {}).items()]

    def _run(self, *args):
        cmd = [self._hadoop, "fs"] + self._configs + list(args)
        r = subprocess.run(cmd, capture_output=True, text=True)
        return r.returncode, r.stdout, r.stderr

    def is_exist(self, path):
        return self._run("-test", "-e", path)[0] == 0

    def is_dir(self, path):
        return self._run("-test", "-d", path)[0] == 0

    def is_file(self, path):
        return self._run("-test", "-f", path)[0] == 0

    def ls(self, path):
        rc, out, err = self._run("-ls", path)
        if rc != 0:
            raise IOError(err)
        return [line.split()[-1] for line in out.splitlines()
                if line and not line.startswith("Found")]

    def makedirs(self, path):
        self._run("-mkdir", "-p", path)

    def delete(self, path):
        self._run("-rm", "-r", "-f", path)

    def rename(self, src, dst, overwrite=False):
        if overwrite:
            self.delete(dst)
        self._run("-mv", src, dst)

    def cat(self, path):
        rc, out, err = self._run("-cat", path)
        if rc != 0:
            raise IOError(err)
        return out

    def upload(self, dest, local):
        self._run("-put", "-f", local, dest)

    def download(self, src, local):
        self._run("-get", src, local)


def split_files(files, trainer_id, trainers):
    """hdfs.py:396 — deterministic round-robin assignment of input files
    to trainers (sorted first so every rank computes the same split)."""
    if trainer_id >= trainers or trainer_id < 0:
        raise ValueError(f"trainer_id {trainer_id} out of range "
                         f"[0, {trainers})")
    return sorted(files)[trainer_id::trainers]
