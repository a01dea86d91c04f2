"""``paddle_tpu_torch.distributed``'s communication, fleet facade and
``LocalFS`` against the JAX package's.

``comm`` over 2 and 4 gloo CPU ranks: the JAX package's collectives act
on a stacked ``[group, ...]`` array; the port's rank ``r`` passes slice
``r`` and must get slice ``r`` of the JAX result. The counterparts of
``tests/test_fleet.py``'s six tests run the fleet facade on two gloo
ranks (and the role makers and ``LocalFS`` in this process)."""

import functools

import numpy as np
import pytest
from torch_gc_barrier import collect_cycles  # noqa: F401

import torch_dist_workers as W

import jax.numpy as jnp  # noqa: E402

from paddle_tpu.distributed import comm as jcomm  # noqa: E402


@functools.lru_cache(maxsize=None)
def _jax_comm(n):
    st = jnp.asarray(W.stacked_input(n, seed=1, shape=(n, 3)))
    R = jcomm.ReduceOp
    g = jcomm.new_group(list(range(n)))
    out = {
        "reduce_sum": jcomm.reduce(st, 1, R.SUM),
        "reduce_max": jcomm.reduce(st, 0, R.MAX),
        "reduce_avg": jcomm.reduce(st, 0, R.AVG),
        "reduce_scatter": jcomm.reduce_scatter(st),
        "reduce_scatter_min": jcomm.reduce_scatter(st, op=R.MIN),
        "scatter": jcomm.scatter(st[0], src=0),
        "scatter_list": jcomm.scatter(None, [st[1][i] for i in range(n)],
                                      src=1),
        "alltoall": jcomm.alltoall(st),
        "alltoall_list": jcomm.alltoall([st[s] for s in range(n)]),
        "group_reduce": jcomm.reduce(st, 0, group=g),
    }
    res = {k: [np.asarray(v)[r] for r in range(n)] for k, v in out.items()}
    # point to point: rank r receives what rank r - 1 sent
    res["send_recv"] = [np.asarray(jcomm.recv(st, src=(r - 1) % n))
                        for r in range(n)]
    res["isend_irecv"] = [
        np.asarray(jcomm.irecv(st * 2, src=(r - 1) % n).wait())
        for r in range(n)]
    res["split"] = [np.split(np.arange(16.).reshape(2, 8), n, axis=1)[r]
                    for r in range(n)]
    return res


@pytest.fixture(scope="module")
def port(tmp_path_factory):
    handles = {n: W.start_ranks("comm_calls", n,
                                tmp_path_factory.mktemp(f"comm{n}"))
               for n in (2, 4)}
    fleet = W.start_ranks("fleet_calls", 2,
                          tmp_path_factory.mktemp("fleet"))
    out = {n: W.collect(h, timeout=180) for n, h in handles.items()}
    out["fleet"] = W.collect(fleet, timeout=180)
    return out


CALLS = ["reduce_sum", "reduce_max", "reduce_avg", "reduce_scatter",
         "reduce_scatter_min", "scatter", "scatter_list", "alltoall",
         "alltoall_list", "group_reduce", "send_recv", "isend_irecv",
         "split"]


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("call", CALLS)
def test_comm_rank_slice_equals_jax(port, call, n):
    want = _jax_comm(n)[call]
    for r in range(n):
        got = port[n][r][call]
        # sums over 4 ranks may add in another order than jnp.sum
        np.testing.assert_allclose(got, want[r], rtol=1e-6, atol=1e-6,
                                   err_msg=f"{call} rank {r}")


@pytest.mark.parametrize("n", [2, 4])
def test_comm_environment(port, n):
    for r in range(n):
        meta = port[n][r]["meta"]
        assert meta == {"rank": r, "world_size": n, "nranks": n,
                        "initialized": True, "group_nranks": n}


# -- tests/test_fleet.py's counterparts -------------------------------------

def test_init_and_worker_queries(port):
    for r, res in enumerate(port["fleet"]):
        assert res["worker_num"] == 2 and res["worker_index"] == r
        assert res["is_first_worker"] == (r == 0) and res["is_worker"]
        assert res["backend"] == "gloo"


def test_distributed_model_layer_and_hapi(port):
    for res in port["fleet"]:
        assert res["layer_wrapped"] == "DataParallel"
        assert res["layer_out"] == (4, 2)     # this rank's rows of 8
        assert res["model_same"] and res["model_mesh"]
        assert np.isfinite(res["model_loss"])
    assert port["fleet"][0]["model_loss"] == port["fleet"][1]["model_loss"]


def test_distributed_optimizer_records_strategy(port):
    for res in port["fleet"]:
        assert res["opt_strategy"] and res["get_strategy"]


def test_ps_lifecycle_guides_to_collective(port):
    for res in port["fleet"]:
        assert res["ps_raises"] == [True] * 4


def test_role_makers(monkeypatch):
    from paddle_tpu.distributed import fleet as jfleet
    from paddle_tpu_torch.distributed import fleet
    monkeypatch.setenv("PADDLE_TRAINER_ID", "1")
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    for mod in (fleet, jfleet):
        rm = mod.PaddleCloudRoleMaker(is_collective=True)
        assert rm.current_id == 1 and rm.worker_num_ == 2
        rm2 = mod.UserDefinedRoleMaker(current_id=1, worker_num=4)
        assert rm2.current_id == 1 and rm2.worker_num_ == 4
    with pytest.raises(RuntimeError, match="fleet.init"):
        fleet._state["initialized"] = False
        fleet.distributed_optimizer(object())


@pytest.mark.parametrize("pkg", ["paddle_tpu", "paddle_tpu_torch"])
def test_local_fs_roundtrip(tmp_path, pkg):
    """distributed.fs.LocalFS in both packages, step for step."""
    import importlib
    fs = importlib.import_module(f"{pkg}.distributed.fs")
    fleet = importlib.import_module(f"{pkg}.distributed.fleet")
    lfs = fs.LocalFS()
    d = str(tmp_path / "a")
    lfs.mkdirs(d)
    assert lfs.is_dir(d) and lfs.is_exist(d)
    f = str(tmp_path / "a" / "x.txt")
    lfs.touch(f)
    assert lfs.is_file(f)
    with open(f, "w") as fh:
        fh.write("hello")
    assert lfs.cat(f) == "hello"
    dirs, files = lfs.ls_dir(str(tmp_path))
    assert dirs == ["a"] and files == []
    assert lfs.list_dirs(str(tmp_path)) == ["a"]
    lfs.mv(f, str(tmp_path / "y.txt"))
    assert lfs.is_file(str(tmp_path / "y.txt"))
    with pytest.raises(fs.FSFileNotExistsError):
        lfs.mv(str(tmp_path / "missing"), str(tmp_path / "z"))
    lfs.touch(str(tmp_path / "z"))
    with pytest.raises(fs.FSFileExistsError):
        lfs.mv(str(tmp_path / "y.txt"), str(tmp_path / "z"))
    lfs.mv(str(tmp_path / "y.txt"), str(tmp_path / "z"), overwrite=True)
    lfs.delete(d)
    assert not lfs.is_exist(d)
    assert not lfs.need_upload_download()
    for cls in (fs.HDFSClient, fs.AFSClient):
        with pytest.raises(NotImplementedError, match="LocalFS"):
            cls()
    assert fleet.utils.LocalFS is fs.LocalFS
