"""Wrapper of the chunked SSD scan kernels: ``csrc/ssd_scan_bf16.cu``
(bf16, three chunk-parallel passes on the tensor cores) and
``csrc/ssd_scan.cu`` (fp32, CUDA cores).

Takes the layout of ``repro/kernels/ssd_scan/ops.py::ssd`` and follows
the port's kernel policy (``kernels/backend.py``): a CPU tensor takes the
plain version (``ref.ssd_plain``), a CUDA tensor the compiled kernel of
x's dtype or an error. The kernels read (B, S, H, P) and (B, S, G, N) in
place, head h reading group ``h // (H // G)``, and mask the ragged tail
themselves, so the wrapper neither transposes, repeats nor pads; for bf16
it allocates the passes' scratch (each chunk's state, cum and dt). A call
counts one launch however many device kernels it runs
(``DEVICE_KERNELS``). ``init_state`` is folded in around either path in
the reference wrapper's closed form (``ref.fold_init_state``); the
serving path never passes it.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.ssd_scan.ref import fold_init_state, ssd_plain

CSRC = Path(__file__).parent / "csrc"
# each dtype's source, C entry point (its pointer and int arguments) and
# device kernels a call runs
SOURCES = {torch.bfloat16: CSRC / "ssd_scan_bf16.cu",
           torch.float32: CSRC / "ssd_scan.cu"}
_ENTRY = {torch.bfloat16: ("ssd_scan_bf16_launch", 9, 8),
          torch.float32: ("ssd_scan_launch", 7, 9)}
DEVICE_KERNELS = {torch.bfloat16: 3, torch.float32: 1}
HEAD_DIMS = (16, 32, 64)          # P the kernels are built for
STATE_DIMS = (16, 32, 128)        # N the kernels are built for
CHUNK_STEP, MAX_CHUNK = 16, 256   # chunks: multiples of 16 up to 256
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_FN = {}      # dtype -> the typed C entry point, resolved at first launch


def _launcher(dtype):
    fn = _FN.get(dtype)
    if fn is None:
        name, n_ptr, n_int = _ENTRY[dtype]
        fn = getattr(backend.load(SOURCES[dtype]), name)
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN[dtype] = fn
    return fn


def supported(P: int, N: int, chunk: int) -> bool:
    """Whether the kernels take head dim ``P``, state dim ``N`` and
    ``chunk``: P in ``HEAD_DIMS``, N in ``STATE_DIMS`` and a chunk that is
    a multiple of ``CHUNK_STEP`` from it up to ``MAX_CHUNK``, honoured as
    given (the scan's chunks are that long)."""
    return (P in HEAD_DIMS and N in STATE_DIMS and chunk % CHUNK_STEP == 0
            and CHUNK_STEP <= chunk <= MAX_CHUNK)


def _check(x, dt, A, B, C):
    if x.dim() != 4 or B.dim() != 4 or C.shape != B.shape:
        raise ValueError(f"expected x (B, S, H, P) and B, C (B, S, G, N); "
                         f"got {tuple(x.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    Bb, S, H, _ = x.shape
    if (B.shape[:2] != (Bb, S) or tuple(dt.shape) != (Bb, S, H)
            or tuple(A.shape) != (H,) or S == 0 or H % B.shape[2]):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B.shape)} do not fit: "
                         f"need dt (B, S, H), A (H,), S >= 1, H % G == 0")
    if x.dtype not in _DTYPE_CODE or dt.dtype not in _DTYPE_CODE:
        raise TypeError(f"ssd takes float32 or bfloat16 x and dt, got "
                        f"{x.dtype}, {dt.dtype}")
    for name, t in (("B", B), ("C", C)):
        if t.dtype != x.dtype:
            raise TypeError(f"{name} is {t.dtype}, x is {x.dtype}")
    if A.dtype != torch.float32:
        raise TypeError(f"A must be float32, got {A.dtype}")
    for name, t in (("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")


def _launch(x, dt, A, B, C, chunk: int):
    Bb, S, H, Pd = x.shape
    G, N = B.shape[2], B.shape[3]
    if not supported(Pd, N, chunk):
        raise ValueError(f"the ssd_scan kernel takes P in {HEAD_DIMS}, N in "
                         f"{STATE_DIMS} and a chunk that is a multiple of "
                         f"{CHUNK_STEP} up to {MAX_CHUNK}; got P={Pd}, "
                         f"N={N}, chunk={chunk}")
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    y = torch.empty_like(x)
    state = torch.empty((Bb, H, Pd, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = (x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), y.data_ptr(), state.data_ptr())
    if x.dtype == torch.bfloat16:
        for name, t in (("x", x), ("B", B), ("C", C)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must have 16-byte aligned data")
        n_chunks = -(-S // chunk)
        # pass (a) writes each chunk's state from zero into ``work`` and its
        # cum and dt (fp32, over the chunk rounded up to whole 64-row tiles)
        # into ``cumdt``; pass (b) writes the entering states over
        # ``work``, which pass (c) reads
        work = torch.empty(Bb * H * n_chunks * Pd * N, dtype=torch.float32,
                           device=x.device)
        cpad = -(-chunk // 64) * 64
        cumdt = torch.empty(Bb * H * n_chunks * 2 * cpad,
                            dtype=torch.float32, device=x.device)
        rc = _launcher(x.dtype)(*ptrs, work.data_ptr(), cumdt.data_ptr(), Bb,
                                S, H, G, Pd, N, chunk, _DTYPE_CODE[dt.dtype],
                                stream)
    else:
        rc = _launcher(x.dtype)(*ptrs, Bb, S, H, G, Pd, N, chunk,
                                _DTYPE_CODE[x.dtype], _DTYPE_CODE[dt.dtype],
                                stream)
    if rc != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    ssd.launches += 1
    return y, state


def ssd(x, dt, A, B, C, *, chunk: int = 256, init_state=None,
        use_kernel: bool = False):
    """x: (B, S, H, P); dt: (B, S, H); A: (H,) fp32; B/C: (B, S, G, N).
    Returns (y (B, S, H, P) in x's dtype, final_state (B, H, P, N) fp32).

    The tensors' device picks kernel or plain version; ``use_kernel=True``
    demands the kernel and raises on CPU tensors. On the card bf16 runs
    the tensor-core kernel and fp32 the CUDA-core one; each takes the
    (P, N, chunk) that ``supported`` accepts and contiguous tensors (bf16
    also 16-byte aligned data), and raises on anything else.
    """
    _check(x, dt, A, B, C)
    if backend.use_kernel(x, require=use_kernel):
        y, state = _launch(x, dt, A, B, C, chunk)
    else:
        y, state = ssd_plain(x, dt, A, B, C, chunk=chunk)
    if init_state is not None:
        y, state = fold_init_state(y, state, dt, A, C, init_state)
    return y, state


ssd.launches = 0    # kernel launches so far (not plain calls)
