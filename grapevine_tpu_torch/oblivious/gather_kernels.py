"""Fused path-row gather+decrypt and encrypt+scatter (counterpart of
``grapevine_tpu/oblivious/pallas_gather.py``), and the build of the
port's CUDA library.

Four functions under the reference's names, each with a hand-written
Hopper kernel (ChaCha core in ``csrc/chacha.cuh``). Two contracts, two
designs of each:

- :func:`gather_decrypt_rows` (the row ring, one row a step) and
  :func:`gather_decrypt_rows_tiled` (one CTA per row, keystream in shared
  memory) fetch the rows at public bucket ids and decrypt them in one
  pass into fresh outputs (``rounds=0``: a plain gather);
  ``csrc/gather_kernels.cu``, plain version
  :func:`gather_decrypt_rows_plain`;
- :func:`scatter_encrypt_rows` (one row a step) and
  :func:`scatter_encrypt_rows_tiled` (up to 8 rows a step),
  ``csrc/scatter_kernels.cu``: the owned plaintext rows are encrypted
  and written, with the epoch nonce, into the trees IN PLACE (the analog
  of the reference's buffer donation / input-output aliasing). Rows
  whose ``owner`` flag is false are skipped and write nothing: the
  reference's contract says they must not write, and its kernels send
  them to the junk bucket ``n_padded - 1`` only because a Pallas grid
  step always writes its block (that row is never read). Plain version
  :func:`scatter_encrypt_rows_plain`, which keeps the reference's junk
  redirect; comparisons mask the last row.

The one-row gather, both scatters and the row cipher
(``cipher_kernels.py``) are four launches of one kernel body, the row
ring (``csrc/row_ring.cuh``): persistent CTAs stream whole rows through
a shared-memory ring with TMA bulk copies and XOR the keystream in on
the way; :func:`ring_launch_config` says how each launches, and
:func:`last_copy_path` which copy path a launch took.

``bucket_cipher_impl="pallas_fused"`` runs the one-row pair and
``"pallas_fused_tiled"`` the tiled pair, as in the reference. A wrapper
takes its plain version only for tensors on the CPU (the analog of
Pallas interpret mode); for CUDA tensors it launches the kernel or
raises. Each launch adds one to :data:`LAUNCHES`.

Each kernel is also a ``torch.library`` custom op (``torch.ops.gv``),
so a graph capture (``analysis/fx_walk.py``) records one node per
launch instead of failing at ``data_ptr()`` on a fake tensor. The
wrappers enter the op only while a capture is on (:func:`capturing`);
outside one they launch directly, with no dispatcher in the way. The
op's body is the wrapper's own: the plain version on the CPU, the
launch (counted, raising on error) on the card. The scatters write the
trees in place and declare it (``mutates_args``), so a functionalized
capture wraps them in ``auto_functionalized``.

Build: every source in ``csrc/`` is compiled with ``nvcc`` (one process
per ``.cu``, all started together) and linked into one library in
``build/`` at the repository root on first use (a plain C interface
bound with ``ctypes``), keyed by a hash of all the sources, and loaded
once per process. ``ptxas``'s report of every kernel (registers, shared
memory, spills) is kept beside the library (:func:`ptxas_log`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

from .bucket_cipher import row_keystream

#: kernel launches per wrapper since the last :func:`reset_launches`
LAUNCHES = {"gather_decrypt_rows": 0, "gather_decrypt_rows_tiled": 0,
            "scatter_encrypt_rows": 0, "scatter_encrypt_rows_tiled": 0}

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC",
)
_lib = None


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def capturing() -> bool:
    """Is a graph capture on: a proxy, fake or functional mode on the
    dispatch stack (``analysis/fx_walk.py:capture`` runs under all
    three)?"""
    key = torch._C._TorchDispatchModeKey
    return any(torch._C._get_dispatch_mode(k) is not None
               for k in (key.PROXY, key.FAKE, key.FUNCTIONAL))


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _sources() -> list[Path]:
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def build_library() -> Path:
    """Compile every ``csrc/*.cu`` (in parallel) and link them into one
    library in ``build/``, unless a library built from the same sources
    and flags is already there."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = BUILD_DIR / f"libgv_kernels-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        units = [p for p in _sources() if p.suffix == ".cu"]
        objs = [str(Path(tmp) / (u.stem + ".o")) for u in units]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", "-o", o,
                                   str(u)],
                                  stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                  text=True)
                 for u, o in zip(units, objs)]
        errs = [p.communicate()[1] for p in procs]  # waits for every one
        for u, p, err in zip(units, procs, errs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {u.name} ({p.returncode}):\n{err}")
        so = str(Path(tmp) / "lib.so")
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", so, *objs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n{res.stderr}")
        out.with_suffix(".ptxas.txt").write_text("".join(errs))
        os.replace(so, out)  # atomic: a concurrent build sees all or nothing
    return out


def ptxas_log() -> str:
    """``ptxas -v``'s report of every kernel of the built library."""
    return build_library().with_suffix(".ptxas.txt").read_text()


def load_library():
    """The built library, loaded once, with every entry point's C types."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build_library()))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        for name in ("gv_gather_decrypt_rows", "gv_gather_decrypt_rows_tiled",
                     "gv_cipher_rows"):
            getattr(lib, name).argtypes = [p] * 7 + [i64, i32, i32, i32, p]
            getattr(lib, name).restype = i32
        for name in ("gv_scatter_encrypt_rows", "gv_scatter_encrypt_rows_tiled"):
            getattr(lib, name).argtypes = [p] * 9 + [i64, i64, i32, i32, i32, p]
            getattr(lib, name).restype = i32
        lib.gv_scatter_launch_config.argtypes = [i32, i64, i32, i32,
                                                 ctypes.POINTER(i32)]
        for name in ("gv_gather_launch_config", "gv_cipher_launch_config"):
            getattr(lib, name).argtypes = [i64, i32, i32, ctypes.POINTER(i32)]
        for name in ("gv_scatter_launch_config", "gv_gather_launch_config",
                     "gv_cipher_launch_config"):
            getattr(lib, name).restype = i32
        lib.gv_last_copy_path.argtypes = []
        lib.gv_last_copy_path.restype = i32
        _lib = lib
    return _lib


def check_tensor(name: str, t: torch.Tensor, dtype, shape=None) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")


def device_kind(*ts) -> str:
    """``"cpu"`` or ``"cuda"``: the one device every tensor lies on."""
    kinds = {t.device.type for t in ts}
    if kinds == {"cpu"}:
        return "cpu"
    if kinds == {"cuda"} and len({t.device for t in ts}) == 1:
        return "cuda"
    raise ValueError(f"tensors must share one CPU or CUDA device, got {kinds}")


# ----------------------------------------------------------------------
# plain PyTorch versions (the reference the kernels are held against)
# ----------------------------------------------------------------------


def gather_decrypt_rows_plain(key, tree_idx, tree_val, nonces, flat_b, z, rounds):
    """Index, then ``row_keystream``, then XOR → (pidx [R, z], pval [R, z*v])."""
    rows = flat_b.long()
    pidx = tree_idx.reshape(-1, z)[rows]
    pval = tree_val[rows]
    if rounds == 0:
        return pidx, pval
    ks = row_keystream(key, flat_b, nonces[rows], z + tree_val.shape[1], rounds)
    return pidx ^ ks[:, :z], pval ^ ks[:, z:]


def scatter_encrypt_rows_plain(key, tree_idx, tree_val, nonces, flat_b, owner,
                               epoch, new_pidx, new_pval, z, rounds):
    """``row_keystream``, then XOR, then ``index_copy_`` into the trees with
    non-owner rows redirected to the junk bucket ``n_padded - 1``, as the
    reference writes them (the kernels skip them; the last row differs)."""
    n_padded = tree_val.shape[0]
    tgt = torch.where(owner, flat_b, n_padded - 1)
    r = tgt.shape[0]
    ep = epoch[None, :].expand(r, 2)
    ks = row_keystream(key, tgt, ep, z + tree_val.shape[1], rounds)
    rows = tgt.long()
    tree_idx.view(n_padded, z).index_copy_(0, rows, new_pidx ^ ks[:, :z])
    tree_val.index_copy_(0, rows, new_pval ^ ks[:, z:])
    nonces.index_copy_(0, rows, ep.contiguous())
    return tree_idx, tree_val, nonces


# ----------------------------------------------------------------------
# wrappers
# ----------------------------------------------------------------------


def _gather(kernel: str, key, tree_idx, tree_val, nonces, flat_b, z, rounds):
    if capturing():
        return getattr(torch.ops.gv, kernel)(key, tree_idx, tree_val, nonces, flat_b, z,
                                             rounds)
    return _gather_impl(kernel, key, tree_idx, tree_val, nonces, flat_b, z, rounds)


def _gather_impl(kernel: str, key, tree_idx, tree_val, nonces, flat_b, z, rounds):
    n, zv = tree_val.shape
    r = flat_b.shape[0]
    for name, t, shape in (("key", key, (8,)), ("tree_idx", tree_idx, (n * z,)),
                           ("tree_val", tree_val, None),
                           ("nonces", nonces, (n, 2)), ("flat_b", flat_b, (r,))):
        check_tensor(name, t, torch.int32, shape)
    if rounds < 0 or rounds % 2:
        raise ValueError(f"rounds must be a non-negative even count, got {rounds}")
    if device_kind(key, tree_idx, tree_val, nonces, flat_b) == "cpu":
        return gather_decrypt_rows_plain(key, tree_idx, tree_val, nonces,
                                         flat_b, z, rounds)
    out_idx = torch.empty((r, z), dtype=torch.int32, device=tree_val.device)
    out_val = torch.empty((r, zv), dtype=torch.int32, device=tree_val.device)
    err = getattr(load_library(), "gv_" + kernel)(
        key.data_ptr(), tree_idx.data_ptr(), tree_val.data_ptr(),
        nonces.data_ptr(), flat_b.data_ptr(), out_idx.data_ptr(),
        out_val.data_ptr(), r, z, zv, rounds,
        torch.cuda.current_stream(tree_val.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1
    return out_idx, out_val


def gather_decrypt_rows(key, tree_idx, tree_val, nonces, flat_b, z: int,
                        rounds: int = 8):
    """(pidx int32[R, z], pval int32[R, z*v]) — gathered AND decrypted,
    one row a step of the row ring.

    ``key`` int32[8]; ``tree_idx`` int32[n*z]; ``tree_val`` int32[n, z*v];
    ``nonces`` int32[n, 2]; ``flat_b`` int32[R] heap-bucket ids (public).
    """
    return _gather("gather_decrypt_rows", key, tree_idx, tree_val, nonces,
                   flat_b, z, rounds)


def gather_decrypt_rows_tiled(key, tree_idx, tree_val, nonces, flat_b, z: int,
                              rounds: int = 8):
    """:func:`gather_decrypt_rows`'s contract, one CTA per row."""
    return _gather("gather_decrypt_rows_tiled", key, tree_idx, tree_val,
                   nonces, flat_b, z, rounds)


def _scatter(kernel: str, key, tree_idx, tree_val, nonces, flat_b, owner, epoch,
             new_pidx, new_pval, z, rounds):
    args = (key, tree_idx, tree_val, nonces, flat_b, owner, epoch, new_pidx, new_pval)
    if capturing():
        getattr(torch.ops.gv, kernel)(*args, z, rounds)
        return tree_idx, tree_val, nonces
    return _scatter_impl(kernel, *args, z, rounds)


def _scatter_impl(kernel: str, key, tree_idx, tree_val, nonces, flat_b, owner, epoch,
                  new_pidx, new_pval, z, rounds):
    n, zv = tree_val.shape
    r = flat_b.shape[0]
    for name, t, shape in (("key", key, (8,)), ("tree_idx", tree_idx, (n * z,)),
                           ("tree_val", tree_val, None),
                           ("nonces", nonces, (n, 2)), ("flat_b", flat_b, (r,)),
                           ("epoch", epoch, (2,)), ("new_pidx", new_pidx, (r, z)),
                           ("new_pval", new_pval, (r, zv))):
        check_tensor(name, t, torch.int32, shape)
    check_tensor("owner", owner, torch.bool, (r,))
    if rounds <= 0 or rounds % 2:
        raise ValueError(f"rounds must be a positive even count, got {rounds}")
    dev = device_kind(key, tree_idx, tree_val, nonces, flat_b, owner, epoch,
                      new_pidx, new_pval)
    if dev == "cpu":
        return scatter_encrypt_rows_plain(key, tree_idx, tree_val, nonces,
                                          flat_b, owner, epoch, new_pidx,
                                          new_pval, z, rounds)
    err = getattr(load_library(), "gv_" + kernel)(
        key.data_ptr(), tree_idx.data_ptr(), tree_val.data_ptr(),
        nonces.data_ptr(), flat_b.data_ptr(), owner.data_ptr(),
        epoch.data_ptr(), new_pidx.data_ptr(), new_pval.data_ptr(), r, n, z,
        zv, rounds, torch.cuda.current_stream(tree_val.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")
    LAUNCHES[kernel] += 1
    return tree_idx, tree_val, nonces


def scatter_encrypt_rows(key, tree_idx, tree_val, nonces, flat_b, owner, epoch,
                         new_pidx, new_pval, z: int, rounds: int):
    """Encrypt + write back owned path rows in ONE pass, in place, one row
    a step.

    ``owner`` bool[R] (public; False rows write nothing, on the card —
    the plain version sends them to the junk bucket as the reference
    does); ``epoch`` int32[2] the write epoch; ``new_pidx`` int32[R, z],
    ``new_pval`` int32[R, z*v] plaintext rows. Updates ``tree_idx``,
    ``tree_val`` and ``nonces`` in place and returns them."""
    return _scatter("scatter_encrypt_rows", key, tree_idx, tree_val, nonces,
                    flat_b, owner, epoch, new_pidx, new_pval, z, rounds)


def scatter_encrypt_rows_tiled(key, tree_idx, tree_val, nonces, flat_b, owner,
                               epoch, new_pidx, new_pval, z: int, rounds: int):
    """:func:`scatter_encrypt_rows`'s contract, up to 8 rows a step."""
    return _scatter("scatter_encrypt_rows_tiled", key, tree_idx, tree_val,
                    nonces, flat_b, owner, epoch, new_pidx, new_pval, z, rounds)


# ----------------------------------------------------------------------
# the kernels as custom ops (entered only under a graph capture)
# ----------------------------------------------------------------------


def _register_ops():
    gather_schema = ("(Tensor key, Tensor tree_idx, Tensor tree_val, Tensor nonces, "
                     "Tensor flat_b, int z, int rounds) -> (Tensor, Tensor)")
    scatter_schema = ("(Tensor key, Tensor(a!) tree_idx, Tensor(b!) tree_val, "
                      "Tensor(c!) nonces, Tensor flat_b, Tensor owner, Tensor epoch, "
                      "Tensor new_pidx, Tensor new_pval, int z, int rounds) -> ()")

    def gather_op(kernel):
        def body(key, tree_idx, tree_val, nonces, flat_b, z, rounds):
            return _gather_impl(kernel, key, tree_idx, tree_val, nonces, flat_b, z, rounds)

        op = torch.library.custom_op(f"gv::{kernel}", body, mutates_args=(),
                                     schema=gather_schema)

        @op.register_fake
        def _(key, tree_idx, tree_val, nonces, flat_b, z, rounds):
            r = flat_b.shape[0]
            return flat_b.new_empty((r, z)), tree_val.new_empty((r, tree_val.shape[1]))

    def scatter_op(kernel):
        def body(key, tree_idx, tree_val, nonces, flat_b, owner, epoch, new_pidx,
                 new_pval, z, rounds):
            _scatter_impl(kernel, key, tree_idx, tree_val, nonces, flat_b, owner, epoch,
                          new_pidx, new_pval, z, rounds)

        op = torch.library.custom_op(f"gv::{kernel}", body,
                                     mutates_args=("tree_idx", "tree_val", "nonces"),
                                     schema=scatter_schema)

        @op.register_fake
        def _(key, tree_idx, tree_val, nonces, flat_b, owner, epoch, new_pidx, new_pval,
              z, rounds):
            return None

    for k in ("gather_decrypt_rows", "gather_decrypt_rows_tiled"):
        gather_op(k)
    for k in ("scatter_encrypt_rows", "scatter_encrypt_rows_tiled"):
        scatter_op(k)


_register_ops()


#: the C entry point that plans each row-ring launch, and its leading
#: arguments
_RING_CONFIG = {
    "scatter_encrypt_rows": ("gv_scatter_launch_config", (0,)),
    "scatter_encrypt_rows_tiled": ("gv_scatter_launch_config", (1,)),
    "gather_decrypt_rows": ("gv_gather_launch_config", ()),
    "cipher_rows_pallas": ("gv_cipher_launch_config", ()),
}


def ring_launch_config(kernel: str, rows: int, z: int, zv: int) -> dict:
    """How ``kernel`` (a row-ring launch: either scatter,
    ``gather_decrypt_rows`` or ``cipher_rows_pallas``) launches at these
    shapes on the card: its persistent grid, rows per step, shared memory
    a CTA and CTAs an SM."""
    if kernel not in _RING_CONFIG:
        raise ValueError(f"{kernel} is not a row-ring launch")
    entry, lead = _RING_CONFIG[kernel]
    out = (ctypes.c_int * 4)()
    err = getattr(load_library(), entry)(*lead, rows, z, zv, out)
    if err != 0:
        raise RuntimeError(f"{kernel} launch config failed: cudaError {err}")
    return dict(grid=out[0], rows_per_step=out[1], smem_bytes=out[2],
                ctas_per_sm=out[3])


def last_copy_path() -> str:
    """The copy path the calling thread's latest kernel launch took, as the
    launch chose it from the row widths and its pointers' alignment:
    ``"vector"`` (16-byte vectors; TMA bulk copies in a row-ring launch)
    or ``"word"`` (4-byte words)."""
    v = load_library().gv_last_copy_path()
    if v < 0:
        raise RuntimeError("no kernel was launched on this thread")
    return "vector" if v else "word"
