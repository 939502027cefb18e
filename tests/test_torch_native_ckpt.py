"""The port's checkpoint engine (``native/``: the same ``ddp_io.cpp``, its
ctypes bindings over tensors), ``tests/test_native_ckpt.py`` in the port,
plus archives crossing between the two packages in both directions."""

import numpy as np
import pytest
import torch

import ddp_generator_tpu.native as jn
import ddp_generator_tpu_torch as td
from ddp_generator_tpu_torch.models import car_parking as tcar
from ddp_generator_tpu_torch.native import (
    AsyncCheckpointWriter,
    build,
    load_arrays,
    load_pytree,
    native_available,
    save_arrays,
    save_pytree,
)
from ddp_generator_tpu_torch.solver import _masked_steps, _running


@pytest.fixture(scope="module", autouse=True)
def built():
    build()
    assert native_available()


def _arrays():
    return {
        "a": np.arange(12, dtype=np.float32).reshape(3, 4),
        "b/c": np.random.default_rng(0).standard_normal((2, 3, 5)),
        "flags": np.array([True, False, True]),
        "idx": np.arange(7, dtype=np.int32),
        "scalar": np.array(3.5),
    }


def _same(out, arrays):
    assert set(out) == set(arrays)
    for k, v in arrays.items():
        np.testing.assert_array_equal(out[k], v)
        assert out[k].dtype == v.dtype and out[k].shape == v.shape


def test_roundtrip_arrays_and_tensors(tmp_path):
    arrays = _arrays()
    p = str(tmp_path / "ck.ddpt")
    save_arrays(p, arrays)
    _same(load_arrays(p), arrays)
    save_arrays(p, {k: torch.from_numpy(v) for k, v in arrays.items()})
    _same(load_arrays(p), arrays)
    with pytest.raises(ValueError, match="bfloat16"):
        save_arrays(p, {"x": torch.ones(2, dtype=torch.bfloat16)})


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_archives_cross_packages(tmp_path, writer):
    """An archive one package writes, the other reads back equal."""
    arrays = _arrays()
    p = str(tmp_path / "x.ddpt")
    save, load = ((jn.save_arrays, load_arrays) if writer == "jax"
                  else (save_arrays, jn.load_arrays))
    save(p, arrays)
    _same(load(p), arrays)


def test_corruption_detected(tmp_path):
    p = str(tmp_path / "ck.ddpt")
    save_arrays(p, {"x": np.ones(100, np.float64)})
    raw = bytearray(open(p, "rb").read())
    raw[200] ^= 0xFF  # flip a payload byte
    open(p, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="CRC|truncated|ddpio"):
        load_arrays(p)


def test_async_writer(tmp_path):
    w = AsyncCheckpointWriter(max_queue=8)
    paths = []
    for i in range(5):
        p = str(tmp_path / f"ck{i}.ddpt")
        assert w.submit(p, {"step": torch.full((64, 64), float(i))})
        paths.append(p)
    w.drain()
    assert w.completed == 5 and w.failed == 0
    for i, p in enumerate(paths):
        assert load_arrays(p)["step"][0, 0] == i
    w.close()


def test_pytree_roundtrip(tmp_path):
    tree = {
        "xs": torch.ones((4, 3), dtype=torch.float64),
        "nested": {"mu": torch.zeros((2,)),
                   "it": torch.tensor(7, dtype=torch.int32)},
    }
    p = str(tmp_path / "tree.ddpt")
    save_pytree(p, tree)
    # the JAX package's leaf names
    assert sorted(load_arrays(p)) == [
        "['nested']/['it']", "['nested']/['mu']", "['xs']"]
    like = {
        "xs": torch.zeros((4, 3), dtype=torch.float64),
        "nested": {"mu": torch.ones((2,)),
                   "it": torch.tensor(0, dtype=torch.int32)},
    }
    out = load_pytree(p, like)
    assert list(out) == ["xs", "nested"]
    torch.testing.assert_close(out["xs"], tree["xs"])
    # 0-d scalars round-trip as 0-d
    assert out["nested"]["it"].shape == () and int(out["nested"]["it"]) == 7
    with pytest.raises(KeyError, match="missing"):
        load_pytree(p, {"other": torch.zeros(1)})


def test_solver_carry_checkpoint_resume(tmp_path):
    """A StepwiseSolver carry checkpointed mid-solve, restored and resumed
    gives the uninterrupted solve's Solution bit for bit."""
    p, x0, _ = tcar.default_setup(T=60)
    rng = np.random.default_rng(0)
    B = 2
    x0s = np.tile(np.asarray(x0), (B, 1))
    u0s = 0.1 * rng.standard_normal((B, 60, 2))
    opts = td.SolverOptions(max_iter=30, debug_level=0,
                            backpass_method="kernel",
                            linesearch_method="kernel")
    s = td.StepwiseSolver(tcar.car_parking(), opts, chunk=5, device="cpu")

    P = s._cast_params(p, B, u0s.shape[1])
    carry = s._init(x0s, u0s, P)
    carry, _ = _masked_steps(s._body, carry, P, opts.max_iter, 5)
    ckpt = str(tmp_path / "carry.ddpt")
    save_pytree(ckpt, carry)
    carry2 = load_pytree(ckpt, carry)
    assert type(carry2) is type(carry)
    carry2, _ = _masked_steps(s._body, carry2, P, opts.max_iter, 1000)
    assert not _running(carry2, opts.max_iter).any()
    resumed = td.to_numpy(s._finalize(carry2))
    direct = td.to_numpy(s(x0s, u0s, p))
    for f in direct._fields:
        np.testing.assert_array_equal(getattr(resumed, f),
                                      getattr(direct, f), err_msg=f)
