"""The plain version of the block-column write against the JAX package's
``block_column_write`` (interpret mode) and ``lax.dynamic_update_slice``,
bit for bit, columns outside the window included (CPU)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lqrrt_tpu.ops.pallas.write_kernel import block_column_write
from lqrrt_tpu_torch.ops.kernels.write_kernel import (block_write,
                                                      block_write_plain)

torch.set_num_threads(2)

A, N, B = 5, 4096, 1024


def _bufs(C, seed):
    rng = np.random.default_rng(seed)
    dst = rng.normal(size=(A, C, N)).astype(np.float32)
    src = rng.normal(size=(A, C, B)).astype(np.float32)
    return dst, src


def _port(dst, src, start):
    d = torch.from_numpy(dst.copy())
    out = block_write(d, torch.from_numpy(src),
                      torch.tensor(start, dtype=torch.int32))
    assert out is d                     # in place
    return d.numpy()


@pytest.mark.parametrize("C", [6, 3])
@pytest.mark.parametrize("start", [0, 512, 1536, N - B])
def test_matches_pallas_and_dus(C, start):
    dst, src = _bufs(C, start + C)
    got = _port(dst, src, start)
    pallas = np.asarray(block_column_write(
        jnp.asarray(dst), jnp.asarray(src), jnp.asarray(start, jnp.int32),
        lane_block=512, interpret=True))
    z = jnp.asarray(0, jnp.int32)
    dus = np.asarray(jax.lax.dynamic_update_slice(
        jnp.asarray(dst), jnp.asarray(src), (z, z, jnp.asarray(start))))
    np.testing.assert_array_equal(got.view(np.int32), pallas.view(np.int32))
    np.testing.assert_array_equal(got.view(np.int32), dus.view(np.int32))


@pytest.mark.parametrize("start", [1, 777, 1003, N - 100, N - 2, -3,
                                   -B - 1])
def test_any_start_masked_at_n(start):
    """Unaligned starts land exactly; columns outside [0, N) are
    dropped, for negative starts too."""
    dst, src = _bufs(3, abs(start))
    got = _port(dst, src, start)
    want = dst.copy()
    lo, hi = max(start, 0), min(start + B, N)
    if hi > lo:
        want[:, :, lo:hi] = src[:, :, lo - start:hi - start]
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


def test_plain_version_is_the_cpu_path():
    dst, src = _bufs(6, 9)
    a = torch.from_numpy(dst.copy())
    block_write_plain(a, torch.from_numpy(src),
                      torch.tensor(512, dtype=torch.int32))
    np.testing.assert_array_equal(a.numpy(), _port(dst, src, 512))


def test_rejects_bad_inputs():
    dst, src = _bufs(6, 1)
    s = torch.tensor(0, dtype=torch.int32)
    with pytest.raises(ValueError):
        block_write(torch.from_numpy(dst), torch.from_numpy(src[:, :3]), s)
    with pytest.raises(TypeError):
        block_write(torch.from_numpy(dst), torch.from_numpy(src),
                    torch.tensor(0, dtype=torch.int64))
    with pytest.raises(ValueError):
        block_write(torch.from_numpy(dst).transpose(0, 1),
                    torch.from_numpy(src).transpose(0, 1), s)


def test_kernel_times_needs_a_card(monkeypatch):
    """The B and C timing tool measures the card only: without one it
    raises and prints nothing."""
    from lqrrt_tpu_torch.tools import kernel_times

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        kernel_times.main(reps=1)
