"""Conv + BatchNorm(train) + swish backward as a Hopper kernel (K6).

Counterpart of ``remora_tpu/kernels/pallas_convbn.py``:
``conv_bn_swish_bwd`` computes the whole backward of a stride-1
``swish(BN_train(conv1d(x, w)))`` block — swish', the dgamma/dbeta batch
sums, the folded BN cotangent, dw, db and dx — in ``csrc/convbn_bwd.cu``
(its note gives the design and the bound). A CUDA tensor goes to the
kernel and a CPU tensor to the plain version,
``conv_bn_swish_bwd_reference``; there is no fallback: a CUDA input the
kernel does not take, a failed build or a refused launch raises.
"""

import collections
import ctypes

import torch

from remora_tpu_torch.kernels import _build

# kernel launches in this process: one per conv_bn_swish_bwd call on CUDA,
# in all and by block shape (Ti, I, O, K)
LAUNCHES = 0
LAUNCHES_BY_SHAPE = collections.Counter()

_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _check_shapes(x, dout, w, stride):
    if stride != 1:
        raise ValueError(
            f"conv_bn_swish_bwd: stride 1 only (the strided blocks take "
            f"ConvBNSwish), got stride {stride}"
        )
    if x.dim() != 3 or dout.dim() != 3 or w.dim() != 3:
        raise ValueError("conv_bn_swish_bwd: x, dout and w must be 3-D")
    B, Ti, I = x.shape
    O, K = w.shape[0], w.shape[2]
    To = Ti - K + 1
    if w.shape[1] != I:
        raise ValueError(
            f"conv_bn_swish_bwd: w {tuple(w.shape)} does not take I={I}"
        )
    if tuple(dout.shape) != (B, To, O):
        raise ValueError(
            f"conv_bn_swish_bwd: dout {tuple(dout.shape)} is not (B, To, O) "
            f"= {(B, To, O)}"
        )
    return B, Ti, I, O, K, To


def conv_bn_swish_bwd_reference(x, dout, w, gamma, beta, mu, r, stride=1,
                                need_dx=True):
    """Plain version of K6: (dx (B, Ti, I) in x's dtype or None, dw (O, I,
    K), db, dgamma, dbeta (O,), all f32), ``_bwd_kernel``'s math and
    rounding points. x (B, Ti, I) and dout (B, To, O) are channels-last; w
    is cast to x's dtype; the conv and both products take f32 sums of the
    rounded operands, one matmul per tap summed over the taps in order (the
    Pallas kernel's K matmuls); dy is f32, db its sum, and it is rounded to
    x's dtype before the dw and dx products; dx is rounded once."""
    B, Ti, I, O, K, To = _check_shapes(x, dout, w, stride)
    x32 = x.float()
    wk = w.to(x.dtype).float()
    gamma, beta, mu, r = (v.float() for v in (gamma, beta, mu, r))
    y = sum(x32[:, k:k + To] @ wk[:, :, k].T for k in range(K))
    xhat = (y - mu) * r
    z = gamma * xhat + beta
    s = torch.sigmoid(z)
    dz = dout.float() * (s + z * s * (1.0 - s))
    dgamma = (dz * xhat).sum((0, 1))
    dbeta = dz.sum((0, 1))
    n = torch.tensor(float(B * To), dtype=torch.float32)
    gr = gamma * r
    dy = gr * (dz - dbeta / n - xhat * (dgamma / n))
    db = dy.sum((0, 1))
    dyk = dy.to(x.dtype).float()
    dw = torch.stack([torch.einsum("bto,bti->oi", dyk, x32[:, k:k + To])
                      for k in range(K)], dim=2)
    dx = None
    if need_dx:
        dx = x32.new_zeros((B, Ti, I))
        for k in range(K):
            dx[:, k:k + To] += dyk @ wk[:, :, k]
        dx = dx.to(x.dtype)
    return dx, dw, db, dgamma, dbeta


def _library():
    lib = _build.load("convbn_bwd")
    if not getattr(lib, "_typed", False):
        ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        for sfx in _SUFFIX.values():
            fn = getattr(lib, f"convbn_bwd_{sfx}")
            fn.argtypes = ([ptr, i64, i64, i64] * 2 + [ptr] * 3 + [i32] * 5
                           + [ptr] * 6)
            fn.restype = i32
        lib.convbn_bwd_workspace_bytes.argtypes = [i32] * 6
        lib.convbn_bwd_workspace_bytes.restype = i64
        lib.convbn_bwd_path.argtypes = [i32] * 6
        lib.convbn_bwd_path.restype = i32
        lib.convbn_bwd_pack_dims.argtypes = [i32] * 4 + [ptr]
        lib.convbn_bwd_pack_dims.restype = None
        for fn in ("convbn_bwd_max_k", "convbn_bwd_max_c"):
            getattr(lib, fn).argtypes = []
            getattr(lib, fn).restype = i32
        lib.convbn_bwd_error_string.argtypes = [i32]
        lib.convbn_bwd_error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


# the kernel's product paths (csrc/convbn_bwd.cu, enum Path)
PATH_ROWS, PATH_MMA, PATH_TILES = 0, 1, 2
PRODUCTS = {PATH_ROWS: "fp32 rows", PATH_MMA: "mma.sync bf16",
            PATH_TILES: "fp32 register tiles"}


def products(B, Ti, I, O, K, dtype):
    """The name of the product path K6 takes for this block shape and
    dtype (``PRODUCTS``), as the library picks it; None where no kernel
    takes the shape."""
    return PRODUCTS.get(
        _library().convbn_bwd_path(B, Ti, I, O, K, dtype.itemsize))


def pack_weights(w):
    """(C_out, C_in, K) f32 -> the row kernels' float4 groups of 4 output
    channels, (ceil(C_out / 4), K, C_in, 4), zero-padded."""
    c_out, c_in, K = w.shape
    groups = -(-c_out // 4)
    wp = w.new_zeros((groups * 4, c_in, K))
    wp[:c_out] = w
    return wp.view(groups, 4, c_in, K).permute(0, 3, 2, 1).contiguous()


def pack_weights_mma(w, n_pad, c_pad):
    """(C_out, C_in, K) -> the tensor-core products' B operand, (K, n_pad,
    c_pad) bf16: wq[k, n, c] = w[n, c, k], zero past C_out and C_in (each
    output channel's input channels contiguous: mma's col layout)."""
    c_out, c_in, K = w.shape
    wq = w.new_zeros((K, n_pad, c_pad), dtype=torch.bfloat16)
    wq[:, :c_out, :c_in] = w.permute(2, 0, 1)
    return wq


def pack_weights_tiles(w, n_pad, c_pad):
    """(C_out, C_in, K) -> the f32 register tiles' weights, (K, c_pad,
    n_pad) f32: wq[k, c, n] = w[n, c, k], zero past C_out and C_in."""
    c_out, c_in, K = w.shape
    wq = w.new_zeros((K, c_pad, n_pad), dtype=torch.float32)
    wq[:, :c_in, :c_out] = w.permute(2, 1, 0)
    return wq


def _packed(lib, path, w):
    """w (C_out, C_in, K) f32 packed for ``path``, padded as the library
    asks (``convbn_bwd_pack_dims``)."""
    if path == PATH_ROWS:
        return pack_weights(w)
    dims = (ctypes.c_int * 2)()
    lib.convbn_bwd_pack_dims(path, w.shape[1], w.shape[0], w.shape[2],
                             ctypes.addressof(dims))
    pack = pack_weights_mma if path == PATH_MMA else pack_weights_tiles
    return pack(w, dims[0], dims[1])


def _channels_first(t):
    """(B, T, C) -> its (B, C, T) view with unit stride along T (a copy
    when the rows are not contiguous)."""
    v = t.transpose(1, 2)
    if v.stride(2) != 1:
        v = v.contiguous()
    return v


def conv_bn_swish_bwd(x, dout, w, gamma, beta, mu, r, stride=1,
                      need_dx=True):
    """K6: (dx, dw, db, dgamma, dbeta) of a stride-1 conv+BN(train)+swish
    block, as ``pallas_convbn.conv_bn_swish_bwd`` returns them: dx (B, Ti,
    I) in x's dtype (None unless ``need_dx``), dw (O, I, K) and db, dgamma,
    dbeta (O,) in f32. x (B, Ti, I) and dout (B, To, O) may be any strided
    views; mu and r are the forward's biasless batch mean and rsqrt(var +
    eps)."""
    global LAUNCHES
    if x.device.type == "cpu":
        return conv_bn_swish_bwd_reference(x, dout, w, gamma, beta, mu, r,
                                           stride, need_dx)
    if x.device.type != "cuda":
        raise ValueError(f"conv_bn_swish_bwd: no kernel for device {x.device}")
    if x.dtype not in _SUFFIX:
        raise ValueError(f"conv_bn_swish_bwd: unsupported dtype {x.dtype}")
    B, Ti, I, O, K, To = _check_shapes(x, dout, w, stride)
    for t in (dout, w, gamma, beta, mu, r):
        if t.device != x.device:
            raise ValueError("conv_bn_swish_bwd: operands on different "
                             "devices")
    if dout.dtype != x.dtype:
        raise ValueError(
            f"conv_bn_swish_bwd: dout is {dout.dtype}, x {x.dtype}"
        )
    lib = _library()
    path = lib.convbn_bwd_path(B, Ti, I, O, K, x.element_size())
    if path < 0:
        raise ValueError(
            f"conv_bn_swish_bwd: kernel takes K <= {lib.convbn_bwd_max_k()}, "
            f"I, O <= {lib.convbn_bwd_max_c()}, Ti >= K and an input tile "
            f"of C_in x (rows + K - 1) f32 within 227 KB of shared memory, "
            f"got B={B}, Ti={Ti}, I={I}, O={O}, K={K}"
        )
    # the tensor-core path copies x time-major itself and reads dout by
    # its strides; the others want unit stride along T
    x_cf = x.transpose(1, 2) if path == PATH_MMA else _channels_first(x)
    g_cf = dout.transpose(1, 2) if path == PATH_MMA else _channels_first(dout)
    wk = w.detach().to(x.dtype).float()
    wp_y = _packed(lib, path, wk)
    wp_dx = _packed(lib, path, wk.transpose(0, 1).flip(2))
    sv = torch.stack([v.detach().float() for v in (gamma, beta, mu, r)])
    dev = x.device
    ws = torch.empty(
        lib.convbn_bwd_workspace_bytes(B, Ti, I, O, K, x.element_size()),
        dtype=torch.uint8, device=dev,
    )
    # dx comes out time-major (B, Ti, I) on the tensor-core path
    dx_shape = (B, Ti, I) if path == PATH_MMA else (B, I, Ti)
    dx_out = (torch.empty(dx_shape, dtype=x.dtype, device=dev)
              if need_dx else None)
    dw = torch.empty((O, I, K), dtype=torch.float32, device=dev)
    db = torch.empty(O, dtype=torch.float32, device=dev)
    dgb = torch.empty((2, O), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = getattr(lib, f"convbn_bwd_{_SUFFIX[x.dtype]}")(
            x_cf.data_ptr(), *x_cf.stride(), g_cf.data_ptr(),
            *g_cf.stride(), wp_y.data_ptr(), wp_dx.data_ptr(),
            sv.data_ptr(), B, Ti, I, O, K,
            None if dx_out is None else dx_out.data_ptr(), dw.data_ptr(),
            db.data_ptr(), dgb.data_ptr(), ws.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            "conv_bn_swish_bwd kernel launch failed: "
            f"{lib.convbn_bwd_error_string(err).decode()} (cudaError {err})"
        )
    LAUNCHES += 1
    LAUNCHES_BY_SHAPE[(Ti, I, O, K)] += 1
    dx = dx_out
    if dx is not None and path != PATH_MMA:
        dx = dx.transpose(1, 2)
    return dx, dw, db, dgb[0], dgb[1]
