"""A NumPy reference for ``AcceleratedOperator``'s four boundary methods
(``embed``, ``embed_left``, ``restore``, ``restore_right``), and the check
that holds the port's to it bit for bit.

The reference is the host route, written out: copy the input to the host,
gather it by the permutation with NumPy indexing into a zeroed tensor (the
embed dtype: float64 for a float64 container, float32 otherwise), or
scatter a result into a zeroed NumPy array.  No JAX here, so that the card's
test file can use it too.
"""

import numpy as np
import torch

from eigenex_tpu_torch.sparse.accelerate import accelerate
from eigenex_tpu_torch.utils.exceptions import EigenexError


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _perms(acc):
    rows = acc.row_perm if acc.row_perm is not None else acc.perm
    return rows, acc.perm


def embed(acc, v, left: bool = False) -> torch.Tensor:
    """``acc.embed(v)`` (``left``: ``acc.embed_left(v)``), on the host."""
    v = _host(v)
    squeeze = v.ndim == 1
    if squeeze:
        v = v[:, None]
    n = acc.orig_shape[0 if left else 1]
    if v.shape[0] != n:
        raise EigenexError(f"{'embed_left' if left else 'embed'} expects length {n}, got {v.shape[0]}")
    if acc.complexified and not left:
        v = np.concatenate([v.real, v.imag], axis=0)
    elif np.iscomplexobj(v):
        raise EigenexError("complex vector for a real operator")
    perm = _perms(acc)[0 if left else 1]
    dtype = torch.float64 if acc.matrix.dtype == torch.float64 else torch.float32
    out = torch.zeros((acc.shape[0 if left else 1], v.shape[1]), dtype=dtype)
    out[: len(perm)] = torch.as_tensor(v[perm]).to(dtype)
    if squeeze:
        out = out[:, 0]
    return out.contiguous()


def restore(acc, V, right: bool = False) -> np.ndarray:
    """``acc.restore(V)`` (``right``: ``acc.restore_right(V)``)."""
    V = _host(V)
    squeeze = V.ndim == 1
    if squeeze:
        V = V[:, None]
    pad = acc.shape[1 if right else 0]
    if V.shape[0] != pad:
        raise EigenexError(f"{'restore_right' if right else 'restore'} expects length {pad}, got {V.shape[0]}")
    perm = _perms(acc)[1 if right else 0]
    out = np.zeros((len(perm), V.shape[1]), V.dtype)
    out[perm] = V[: len(perm)]
    if acc.complexified and not right:
        n = acc.orig_shape[0]
        out = out[:n] + 1j * out[n:]
    if squeeze:
        out = out[:, 0]
    return out


def operator(kind: str, container: torch.dtype, device):
    """A small operator of ``kind`` ("square": real symmetric band,
    "rectangular": real 300 x 200, "complexified": complex Hermitian band)
    in a ``container`` pack on ``device``, relabelled at random so that the
    permutation has work to do.  Dyadic values: bfloat16 holds them."""
    rng = np.random.default_rng(7)
    if kind == "rectangular":
        m, n = 300, 200
        r = np.repeat(np.arange(m), 3)
        c = np.clip((r * n) // m + rng.integers(-20, 20, size=len(r)), 0, n - 1)
        r, c = np.unique(np.stack([r, c]), axis=1)
        v = np.round(rng.standard_normal(len(r)) * 8) / 8 + 0.0625
        return accelerate((rng.permutation(m)[r], rng.permutation(n)[c], v, (m, n)),
                          dtype=container, device=device)
    n = 150
    r = np.repeat(np.arange(n), 2)
    c = r + rng.integers(1, 9, size=len(r))
    r, c = np.unique(np.stack([r, c])[:, c < n], axis=1)
    v = np.round(rng.standard_normal(len(r)) * 8) / 8 + 0.0625
    if kind == "complexified":
        v = v * np.array([1, 1j, -1, -1j])[rng.integers(0, 4, size=len(r))]  # exact phases
    relabel = rng.permutation(n)
    rows = relabel[np.concatenate([r, c, np.arange(n)])]
    cols = relabel[np.concatenate([c, r, np.arange(n)])]
    vals = np.concatenate([v, np.conj(v), np.full(n, 4.0)])
    acc = accelerate((rows, cols, vals, (n, n)), dtype=container, block=8, device=device)
    assert acc.complexified == (kind == "complexified")
    return acc


def _inputs(rng, length: int, ndim: int, complex_: bool, source: str, device) -> list:
    shape = (length,) if ndim == 1 else (length, 3)
    x = rng.standard_normal(shape)
    if complex_:
        x = x + 1j * rng.standard_normal(shape)
    if source == "numpy":
        return [x, x.astype(np.complex64 if complex_ else np.float32)]
    t = torch.as_tensor(x)
    return [t.to(device), t.to(torch.complex64 if complex_ else torch.float32).to(device)]


def _same_tensor(got: torch.Tensor, want: torch.Tensor, device):
    assert got.device == torch.device(device) and got.dtype == want.dtype
    assert got.shape == want.shape and got.is_contiguous()
    assert got.cpu().numpy().tobytes() == want.numpy().tobytes()


def _same_array(got: np.ndarray, want: np.ndarray):
    assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def _same_error(call, reference):
    try:
        reference()
    except EigenexError as e:
        want = str(e)
    else:
        raise AssertionError("the reference did not raise")
    try:
        call()
    except EigenexError as e:
        assert str(e) == want
    else:
        raise AssertionError(f"expected EigenexError({want!r})")


def check_against_reference(acc, source: str, ndim: int):
    """Every boundary method of ``acc`` against the reference, for inputs
    from ``source`` ("numpy", or a torch tensor on "cpu" or the card):
    dtype, shape and bytes of every result, the error messages, and two
    successive restores that share no memory."""
    device = acc.device
    at = "cpu" if source == "numpy" else source
    rng = np.random.default_rng(11)
    m, n = acc.orig_shape
    sides = [(False, n)] + ([(True, m)] if acc.row_perm is not None else [])
    for left, length in sides:
        method = acc.embed_left if left else acc.embed
        for v in _inputs(rng, length, ndim, acc.complexified and not left, source, at):
            _same_tensor(method(v), embed(acc, v, left), device)
        _same_error(lambda: method(np.ones(length + 1)), lambda: embed(acc, np.ones(length + 1), left))
        if not acc.complexified or left:
            z = np.ones(length) * 1j
            _same_error(lambda: method(z), lambda: embed(acc, z, left))
    for right, pad in [(False, acc.shape[0])] + ([(True, acc.shape[1])] if acc.row_perm is not None else []):
        method = acc.restore_right if right else acc.restore
        for V in _inputs(rng, pad, ndim, False, source, at):
            _same_array(method(V), restore(acc, V, right))
        _same_error(lambda: method(np.ones(pad + 1)), lambda: restore(acc, np.ones(pad + 1), right))
        first, second = method(V), method(V)
        assert not np.shares_memory(first, second)
        first[...] = 0
        _same_array(second, restore(acc, V, right))
