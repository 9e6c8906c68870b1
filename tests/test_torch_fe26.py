"""The 26-bit field layer of the cached verify kernels (csrc/fe26.cuh).

(a) An exact Python-int model of the header's steps (mul, sq, the column
    fold, the carry passes, the subtraction bias, canonical) asserts every
    intermediate against the width the header keeps it in (uint32, uint64,
    int32) and every result against big-int arithmetic mod p, at the lazy
    maxima and on seeded random limbs. Pairing the reference's 13-bit
    limbs (cometbft_tpu.ops.field on seeded inputs) gives the same value.
(b) Where g++ is on the path, the header compiles against a stub
    ``cuda_runtime.h`` into a small harness whose field ops must return the
    model's limbs exactly, and whose decompression must agree with the
    port's ed25519_ref. The stub runs every thread of a block as a fiber
    that yields at each ``__shfl_sync`` and ``__syncthreads``, so the quad
    kernels K1-K4 themselves run on a few lanes against their plain
    versions and the oracle. (tests/test_torch_hashplane.py runs X4 on the
    same stub, whose named barriers it emulates too, and
    tests/test_torch_x1.py the arena builder X1.)
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from cometbft_tpu.ops import field as jfield
from cometbft_tpu_torch.crypto import ed25519_ref as ref
from cometbft_tpu_torch.ops import cuda_verify, curve
from cometbft_tpu_torch.ops import verify as tverify
from cometbft_tpu_torch.ops.build import CSRC

P = 2**255 - 19
NL = 10
MASK = (1 << 26) - 1
FOLD = 608
LAZY = 2**26 + 2**24
PAIRED_MAX = 10015 + (10015 << 13)  # a paired lazy 13-bit limb
BIAS = [(1 << 28) - 4 - 2428] + [(1 << 28) - 4] * (NL - 1)
P_LIMBS = [(1 << 26) - 19] + [(1 << 26) - 1] * 8 + [(1 << 21) - 1]


def u32(x):
    assert 0 <= x < 2**32, x
    return x


def u64(x):
    assert 0 <= x < 2**64, x
    return x


def i32(x):
    assert -(2**31) <= x < 2**31, x
    return x


def value(v):
    return sum(x << (26 * i) for i, x in enumerate(v))


def carry1(v):
    hi = [u32(x) >> 26 for x in v]
    lo = [x & MASK for x in v]
    out = [u32(lo[0] + hi[9] * FOLD)]
    out += [u32(lo[i] + hi[i - 1]) for i in range(1, NL)]
    return out


def fold_cols(c):
    t = [u64(x) for x in c[:NL]]
    for i in range(NL - 1):
        t[i] = u64(t[i] + (c[NL + i] & MASK) * FOLD)
        t[i + 1] = u64(t[i + 1] + (c[NL + i] >> 26) * FOLD)
    r = [None] + [u32((t[i] & MASK) + (t[i - 1] >> 26)) for i in range(1, NL)]
    r0 = u64((t[0] & MASK) + (t[NL - 1] >> 26) * FOLD)
    out = [u32((r0 & MASK) + (r[NL - 1] >> 26) * FOLD),
           u32((r[1] & MASK) + (r0 >> 26))]
    out += [u32((r[i] & MASK) + (r[i - 1] >> 26)) for i in range(2, NL)]
    return out


def mul(a, b):
    c = [0] * (2 * NL - 1)
    for i in range(NL):
        for j in range(NL):
            c[i + j] = u64(c[i + j] + u32(a[i]) * u32(b[j]))
    return fold_cols(c)


def sq(a):
    c = [0] * (2 * NL - 1)
    for i in range(NL):
        c[2 * i] = u64(c[2 * i] + a[i] * a[i])
        d = u32(a[i] << 1)
        for j in range(i + 1, NL):
            c[i + j] = u64(c[i + j] + d * a[j])
    return fold_cols(c)


def add(a, b):
    return carry1([u32(x + y) for x, y in zip(a, b)])


def sub(a, b):
    return carry1([u32(x + k - y) for x, k, y in zip(a, BIAS, b)])


def neg(a):
    return carry1([u32(k - x) for k, x in zip(BIAS, a)])


def canonical(x):
    x = list(x)
    for _ in range(2):
        c = 0
        for i in range(NL - 1):
            v = u32(x[i] + c)
            x[i], c = v & MASK, v >> 26
        v = u32(x[NL - 1] + c)
        x[NL - 1] = v & ((1 << 21) - 1)
        x[0] = u32(x[0] + (v >> 21) * 19)
    y, borrow = [], 0
    for i in range(NL):
        v = i32(i32(x[i]) - P_LIMBS[i] + borrow)
        top = i == NL - 1
        y.append(v & ((1 << 21) - 1 if top else MASK))
        borrow = v >> (21 if top else 26)
    return y if borrow == 0 else x


def pair13(l13):
    return [int(l13[2 * i]) + (int(l13[2 * i + 1]) << 13) for i in range(NL)]


def _inputs():
    rng = np.random.default_rng(20261017)
    vecs = [[LAZY] * NL, [PAIRED_MAX] * NL, [MASK] * NL, [0] * NL,
            [LAZY if i % 2 else 0 for i in range(NL)]]
    vecs += [list(map(int, rng.integers(0, LAZY + 1, NL))) for _ in range(40)]
    vecs += [list(map(int, rng.integers(0, MASK + 1, NL))) for _ in range(20)]
    return vecs


INPUTS = _inputs()


def test_mul_sq_fold_fit_their_widths_and_reduce_mod_p():
    for k, a in enumerate(INPUTS):
        b = INPUTS[(k * 7 + 3) % len(INPUTS)]
        for got, want in ((mul(a, b), value(a) * value(b)),
                          (mul(a, a), value(a) ** 2),
                          (sq(a), value(a) ** 2)):
            assert value(got) % P == want % P
            assert max(got) <= LAZY
        assert sq(a) == mul(a, a)  # the same columns, so the same limbs


def test_worst_case_column_and_fold_stay_inside_int64():
    """Upper bounds of every step at limbs = LAZY, by intervals: a column
    takes the most products, lo26 parts their most, 2^26 - 1."""
    top = LAZY * LAZY
    col = [min(k + 1, 2 * NL - 1 - k) * top for k in range(2 * NL - 1)]
    assert max(col) == 10 * top == 70_368_744_177_664_000 < 2**56
    t = col[:NL]
    for i in range(NL - 1):
        t[i] += MASK * FOLD
        t[i + 1] += (col[NL + i] >> 26) * FOLD
    assert max(t) == t[9] < 2**56
    r = [MASK + (t[i - 1] >> 26) for i in range(1, NL)]
    r0 = MASK + (t[9] >> 26) * FOLD
    assert max(r) < 2**31 and r0 < 2**40
    out = [MASK + (max(r) >> 26) * FOLD, MASK + (r0 >> 26)]
    assert max(out) <= 2**26 + 9_500 < LAZY
    # the header's stated bounds
    assert t[9] <= 70_368_807_931_084_800 and (r0 >> 26) <= 9_501


def test_add_sub_neg_keep_the_lazy_bound():
    assert value(BIAS) % P == 0 and min(BIAS) > LAZY
    for k, a in enumerate(INPUTS):
        b = INPUTS[(k * 5 + 1) % len(INPUTS)]
        for got, want in ((add(a, b), value(a) + value(b)),
                          (sub(a, b), value(a) - value(b)),
                          (neg(a), -value(a))):
            assert value(got) % P == want % P
            assert max(got) <= LAZY


def test_canonical_is_exact_on_lazy_and_noncanonical_values():
    cases = list(INPUTS)
    # y in [p, 2^255) as ZIP-215 admits it, p itself, 2^255 - 1, and p - 1
    for y in [P + k for k in range(19)] + [P - 1, 2**255 - 1, 2 * P - 1]:
        cases.append([(y >> (26 * i)) & MASK for i in range(NL - 1)]
                     + [y >> 234])
    for a in cases:
        c = canonical(a)
        assert value(c) == value(a) % P
        assert all(0 <= x <= MASK for x in c) and c[9] < 2**21


def test_pairing_reference_limbs_keeps_the_value():
    rng = np.random.default_rng(7)
    a = rng.integers(0, 10016, size=(20, 16), dtype=np.int32)
    b = rng.integers(0, 10016, size=(20, 16), dtype=np.int32)
    a[:, 0] = 10015
    prod = np.asarray(jfield.mul(a, b))
    s = np.asarray(jfield.sub(a, b))
    for col in range(16):
        pa, pb = pair13(a[:, col]), pair13(b[:, col])
        assert value(pa) == jfield.from_limbs(a[:, col])
        assert max(pa) <= PAIRED_MAX <= LAZY
        pp = pair13(prod[:, col])
        assert value(pp) == jfield.from_limbs(prod[:, col])
        assert value(pp) % P == value(mul(pa, pb)) % P
        assert value(pair13(s[:, col])) % P == value(sub(pa, pb)) % P


# ------------------------------------------------------------ (b) g++

STUB = r"""
#pragma once
#include <cstdint>
#include <functional>
#include <ucontext.h>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __shared__ static
#define __constant__ static
#define __launch_bounds__(...)
typedef void* cudaStream_t;
enum { cudaFuncAttributePreferredSharedMemoryCarveout = 9,
       cudaSharedmemCarveoutMaxShared = 100 };
static inline int cudaGetDevice(int* d) { *d = 0; return 0; }
template <class F> static inline int cudaFuncSetAttribute(F, int, int) { return 0; }
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct uint4 { uint32_t x, y, z, w; };
static inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) {
  return uint4{x, y, z, w};
}
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, unsigned s) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (s & 31));
}
namespace emu {
struct D3 { unsigned x, y, z; };
inline int cur, nthreads;
inline D3 bidx, bdim;
inline uint32_t xbuf[2][1024];
inline int nshfl[1024];
inline bool done[1024];
inline std::function<void()>* body;
inline std::vector<char> stacks;
constexpr size_t STACK = 1 << 19;
// named barriers: arrivals in the open phase and phases completed; a
// launch whose fibers all wait fails (cudaGetLastError says so)
inline int arrived[16], phases[16];
inline bool failed;
inline void tramp();
#if defined(__x86_64__)
// A switch saves the callee-saved registers on the fiber's own stack and
// swaps stack pointers: no signal-mask system calls, as swapcontext makes
// two a switch, and a launch switches once a thread a shuffle.
extern "C" void emu_fiber_swap(void** save, void* load);
asm(R"(
  .text
  .globl emu_fiber_swap
  .hidden emu_fiber_swap
  .type emu_fiber_swap, @function
emu_fiber_swap:
  pushq %rbp
  pushq %rbx
  pushq %r12
  pushq %r13
  pushq %r14
  pushq %r15
  movq %rsp, (%rdi)
  movq %rsi, %rsp
  popq %r15
  popq %r14
  popq %r13
  popq %r12
  popq %rbx
  popq %rbp
  ret
  .size emu_fiber_swap, .-emu_fiber_swap
)");
inline void* main_sp;
inline void* sp[1024];
inline void fiber_start() {
  tramp();
  __builtin_unreachable();
}
// fiber t's stack: tramp's return address 16-aligned under the top, six
// zero registers below it
inline void make_fiber(int t) {
  uintptr_t top = ((uintptr_t)(stacks.data() + STACK * (t + 1)) & ~(uintptr_t)15) - 16;
  void** p = (void**)top;
  p[0] = (void*)&fiber_start;
  for (int i = 1; i <= 6; ++i) p[-i] = nullptr;
  sp[t] = (void*)(p - 6);
}
inline void switch_to(int me, int n) { emu_fiber_swap(&sp[me], sp[n]); }
inline void to_main(int me) { emu_fiber_swap(&sp[me], main_sp); }
inline void enter(int t) { emu_fiber_swap(&main_sp, sp[t]); }
#else
inline ucontext_t main_ctx, ctx[1024];
inline void make_fiber(int t) {
  getcontext(&ctx[t]);
  ctx[t].uc_stack.ss_sp = stacks.data() + STACK * t;
  ctx[t].uc_stack.ss_size = STACK;
  ctx[t].uc_link = &main_ctx;
  makecontext(&ctx[t], tramp, 0);
}
inline void switch_to(int me, int n) { swapcontext(&ctx[me], &ctx[n]); }
inline void to_main(int me) { swapcontext(&ctx[me], &main_ctx); }
inline void enter(int t) { swapcontext(&main_ctx, &ctx[t]); }
#endif
// switch to the next live fiber after `me`, or back to the launch
inline void run_next(int me) {
  for (int i = 1; i <= nthreads; ++i) {
    int n = (me + i) % nthreads;
    if (!done[n]) {
      if (n == me) return;
      cur = n;
      switch_to(me, n);
      cur = me;
      return;
    }
  }
  to_main(me);
}
inline void tramp() {
  (*body)();
  done[cur] = true;
  run_next(cur);
}
inline void launch(int grid, int block, std::function<void()> f) {
  body = &f;
  failed = false;
  nthreads = block;
  bdim = D3{(unsigned)block, 1, 1};
  stacks.resize(STACK * block);
  for (int b = 0; b < grid; ++b) {
    bidx = D3{(unsigned)b, 0, 0};
    for (int t = 0; t < block; ++t) {
      done[t] = false;
      nshfl[t] = 0;
      make_fiber(t);
    }
    for (int id = 0; id < 16; ++id) arrived[id] = phases[id] = 0;
    cur = 0;
    enter(0);
    if (failed) return;
  }
}
// every live thread of the block writes, then every one reads
inline uint32_t exchange(uint32_t v, int src) {
  int f = cur, k = nshfl[f]++;
  xbuf[k & 1][f] = v;
  run_next(f);
  return xbuf[k & 1][src];
}
// bar.arrive / bar.sync on barrier `id` of `n` threads: the n-th arrival
// completes the phase; a waiting fiber yields until its phase completes
inline void bar_arrive(int id, int n) {
  if (++arrived[id] == n) {
    arrived[id] = 0;
    ++phases[id];
  }
}
inline void bar_sync(int id, int n) {
  const int phase = phases[id];
  bar_arrive(id, n);
  for (int spins = 0; phases[id] == phase; ++spins) {
    if (spins > 4096) {  // every fiber waits: a deadlock
      failed = true;
      to_main(cur);
    }
    run_next(cur);
  }
}
}  // namespace emu
static inline int cudaGetLastError() { return ::emu::failed ? 1 : 0; }
#define threadIdx (::emu::D3{(unsigned)::emu::cur, 0, 0})
#define blockIdx (::emu::bidx)
#define blockDim (::emu::bdim)
static inline void __syncthreads() { ::emu::run_next(::emu::cur); }
static inline uint32_t __shfl_sync(unsigned, uint32_t v, int s, int w) {
  return ::emu::exchange(v, (::emu::cur & ~(w - 1)) + (s & (w - 1)));
}
static inline uint32_t __shfl_xor_sync(unsigned, uint32_t v, int m, int w) {
  return ::emu::exchange(v, (::emu::cur & ~(w - 1)) + ((::emu::cur ^ m) & (w - 1)));
}
static inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  for (int m = 16; m > 0; m >>= 1) {
    const unsigned o = __shfl_xor_sync(~0u, v, m, 32);
    v = v > o ? v : o;
  }
  return v;
}
"""

HARNESS = r"""
#include <cuda_runtime.h>
#include "fe26.cuh"
using namespace f26;
static fe ld(const uint32_t* p) { fe r; for (int i = 0; i < NL; ++i) r.v[i] = p[i]; return r; }
static void st(uint32_t* p, const fe& a) { for (int i = 0; i < NL; ++i) p[i] = a.v[i]; }
// op: 0 mul, 1 sq, 2 add, 3 sub, 4 neg, 5 canonical
extern "C" void fe_op(int op, const uint32_t* a, const uint32_t* b, uint32_t* out) {
  const fe x = ld(a), y = ld(b);
  fe r = op == 0 ? fe_mul(x, y) : op == 1 ? fe_sq(x) : op == 2 ? fe_add(x, y)
       : op == 3 ? fe_sub(x, y) : op == 4 ? fe_neg(x) : fe_canonical(x);
  st(out, r);
}
// sm: N_CONSTS paired constants; returns whether y decodes
extern "C" int decompress(const uint32_t* y, int sign, const uint32_t* sm, uint32_t* x) {
  fe r;
  const bool ok = decompress_x(r, ld(y), sign, sm);
  st(x, fe_canonical(r));
  return ok;
}
"""


def _gpp():
    gpp = shutil.which("g++")
    if gpp is None:
        pytest.skip("g++ is not on the path")
    return gpp


def _compile(tmp, name, source):
    """A C++ shared library from ``source`` against the stub header; a
    kernel launch ``k<<<grid, block, 0, stream>>>(args)`` becomes a fiber
    launch of ``block`` threads per block."""
    (tmp / "cuda_runtime.h").write_text(STUB)
    source = re.sub(r"(\w+)<<<(.*?),\s*(\w+),\s*0,\s*stream>>>\((.*?)\);",
                    r"emu::launch((\2), (\3), [&] { \1(\4); });", source,
                    flags=re.S)
    cpp = tmp / f"{name}.cpp"
    cpp.write_text("#include <cuda_runtime.h>\n" + source)
    so = tmp / f"lib{name}.so"
    subprocess.run([_gpp(), "-O1", "-std=c++17", "-shared", "-fPIC",
                    f"-I{tmp}", f"-I{CSRC}", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    return ctypes.CDLL(str(so))


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    _gpp()
    lib = _compile(tmp_path_factory.mktemp("fe26"), "harness", HARNESS)
    lib.fe_op.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.decompress.argtypes = [ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]
    lib.decompress.restype = ctypes.c_int
    return lib


def _arr(v):
    return np.ascontiguousarray(np.asarray(v, dtype=np.uint32))


def _call(lib, op, a, b):
    out = np.zeros(NL, np.uint32)
    a, b = _arr(a), _arr(b)
    lib.fe_op(op, a.ctypes.data, b.ctypes.data, out.ctypes.data)
    return [int(x) for x in out]


def test_harness_field_ops_equal_the_model_limb_for_limb(harness):
    ops = [mul, sq, add, sub, neg, canonical]
    for k, a in enumerate(INPUTS):
        b = INPUTS[(k * 3 + 2) % len(INPUTS)]
        for code, fn in enumerate(ops):
            want = fn(a, b) if fn in (mul, add, sub) else fn(a)
            assert _call(harness, code, a, b) == want, (fn.__name__, k)


def _paired_consts():
    c = curve.kernel_consts().astype(np.int64)
    return _arr(c[0::2] + (c[1::2] << 13))


def test_harness_decompression_matches_the_oracle(harness):
    sm = _paired_consts()
    encodings = [ref.compress(ref.scalar_mult(k, ref.BASE)) for k in (1, 7, 99)]
    encodings += [((P + k) | (s << 255)).to_bytes(32, "little")
                  for k in range(19) for s in (0, 1)]  # y = p + k
    encodings += [(1 | 1 << 255).to_bytes(32, "little"),  # negative zero
                  (2).to_bytes(32, "little")]  # off the curve
    for enc in encodings:
        y_int = int.from_bytes(enc, "little")
        y = y_int & ((1 << 255) - 1)
        limbs = [(y >> (26 * i)) & MASK for i in range(NL)]
        x = np.zeros(NL, np.uint32)
        ok = harness.decompress(_arr(limbs).ctypes.data, y_int >> 255,
                                sm.ctypes.data, x.ctypes.data)
        pt = ref.decompress(enc)
        assert bool(ok) == (pt is not None), enc.hex()
        if pt is not None:
            zinv = pow(pt[2], P - 2, P)
            assert value([int(v) for v in x]) == pt[0] * zinv % P, enc.hex()


def _lanes():
    """Edge lanes with known verdicts: honest, tampered, small-order and
    non-canonical A and R, negative zero, off-curve points, S >= L. The
    A-side classes decode only in K1 and K3, where threads 0-1 of a quad
    decompress A and threads 2-3 R."""
    r = 123457
    r_enc = ref.compress(ref.scalar_mult(r, ref.BASE))
    rs = r_enc + r.to_bytes(32, "little")
    ident_np = (1 + P).to_bytes(32, "little")
    negzero = (1 | 1 << 255).to_bytes(32, "little")
    off = (2).to_bytes(32, "little")  # y = 2 does not decode
    a8 = ref.compress(chip_smoke._order8_point(ref))
    m8 = next(b"fe26 order 8 %d" % i for i in range(64)
              if ref.challenge_scalar(r_enc, a8, b"fe26 order 8 %d" % i) % 8)
    items = []
    for i in range(7):
        seed = bytes([i + 1]) * 32
        msg = b"fe26 lane %d" % i
        items.append((ref.pubkey_from_seed(seed), msg, ref.sign(seed, msg)))
    pk0, msg0, sig0 = items[0]
    items += [
        (pk0, msg0, bytes([sig0[0] ^ 1]) + sig0[1:]),  # flipped R bit
        (pk0, b"tampered", sig0),
        (ident_np, msg0, rs),  # identity A as y = 1 + p
        (negzero, msg0, rs),  # negative zero A
        (ident_np, msg0, ident_np + bytes(32)),  # R = identity as 1 + p
        (ident_np, msg0, negzero + bytes(32)),  # R negative zero
        (pk0, msg0, negzero + bytes(32)),  # the same R, full-order A
        (pk0, msg0, (2).to_bytes(32, "little") + sig0[32:]),  # R off curve
        (pk0, msg0, sig0[:32] + (ref.L + 1).to_bytes(32, "little")),
    ]
    for k in (0, 3):  # y = p + k as R
        items.append((pk0, msg0, (P + k).to_bytes(32, "little") + sig0[32:]))
    items += [
        (P.to_bytes(32, "little"), msg0, rs),  # A as y = p + 0, order 4
        (a8, m8, rs),  # A of order 8, [k]A != O: cofactored accept
        (off, msg0, sig0),  # A off the curve
        (off, msg0, off + sig0[32:]),  # A and R both off the curve
        (negzero, msg0, off + sig0[32:]),  # A decodes, R does not
    ]
    return [list(x) for x in zip(*items)]


DECOMPRESS_AR = r"""
#include <cuda_runtime.h>
#include "fe26.cuh"
using namespace f26;
// every thread's flag and canonical -R component, and its plane of A's
// table entry 1 (A's affine-Niels form), from q_decompress_ar
__global__ void dec_ar(const int32_t* y_a, const int32_t* sign_a,
                       const int32_t* y_r, const int32_t* sign_r,
                       const int32_t* consts, uint8_t* ok, uint32_t* nr_out,
                       uint32_t* na_out, int n) {
  __shared__ uint32_t sm[N_CONSTS];
  __shared__ uint32_t atab[ATAB_WORDS];
  stage_consts26(sm, consts);
  const int c = quad_c();
  const size_t lane = (size_t)blockIdx.x * 8 + (threadIdx.x >> 2);
  const size_t ln = lane < (size_t)n ? lane : (size_t)n - 1;
  fe nr;
  const bool k =
      q_decompress_ar(y_a, sign_a, y_r, sign_r, n, ln, sm, atab, nr, c);
  const fe nrc = fe_canonical(nr);
  const fe nac = fe_canonical(atab_load(atab, 1, c));
  if (lane >= (size_t)n) return;
  const size_t t = lane * 4 + c;
  ok[t] = k;
  for (int i = 0; i < NL; ++i) {
    nr_out[t * NL + i] = nrc.v[i];
    na_out[t * NL + i] = nac.v[i];
  }
}
extern "C" int run(const int32_t* y_a, const int32_t* sign_a,
                   const int32_t* y_r, const int32_t* sign_r,
                   const int32_t* consts, uint8_t* ok, uint32_t* nr_out,
                   uint32_t* na_out, int n, cudaStream_t stream) {
  dec_ar<<<(n + 7) / 8, 32, 0, stream>>>(y_a, sign_a, y_r, sign_r, consts,
                                         ok, nr_out, na_out, n);
  return 0;
}
"""


def test_quad_decompresses_a_and_r_side_by_side_in_emulation(tmp_path):
    """K1's and K3's prologue (fe26.cuh q_decompress_ar) on the edge
    lanes: threads 0-1 decompress A and threads 2-3 R, so every thread's
    flag must be "A and R both decode" (A's from thread 0, R's from thread
    2), thread c's -R component (y+x, y-x, 2, -2dxy)[c] and its plane
    (y-x, y+x, 2, 2dxy)[c] of A's table must match the oracle's points. A
    point that does not decode leaves the verdict False through the
    equation as well, so only this test sees a wrong flag."""
    lib = _compile(tmp_path, "dec_ar", DECOMPRESS_AR)
    pks, msgs, sigs = _lanes()
    n = len(pks)
    buf, _ = tverify.pack_bytes(pks, msgs, sigs)
    a = tverify.unpack_on_device(torch.from_numpy(buf))
    ok = np.zeros((n, 4), np.uint8)
    nr = np.zeros((n, 4, NL), np.uint32)
    na = np.zeros((n, 4, NL), np.uint32)
    consts = torch.from_numpy(curve.kernel_consts())
    ptrs = [a["y_a"], a["sign_a"], a["y_r"], a["sign_r"], consts]
    args = [ctypes.c_void_p(t.data_ptr()) for t in ptrs]
    args += [ctypes.c_void_p(x.ctypes.data) for x in (ok, nr, na)]
    assert lib.run(*args, ctypes.c_int(n), None) == 0
    d = (-121665 * pow(121666, P - 2, P)) % P

    def affine(enc):
        pt = ref.decompress(enc)
        if pt is None:
            return None
        zinv = pow(pt[2], P - 2, P)
        return pt[0] * zinv % P, pt[1] * zinv % P

    def wire(y, sign, i):  # the encoding the kernel was given
        v = sum(int(y[k, i]) << (13 * k) for k in range(20))
        return (v | int(sign[i]) << 255).to_bytes(32, "little")

    decoded = 0
    for i in range(n):
        pa = affine(wire(a["y_a"], a["sign_a"], i))
        pr = affine(wire(a["y_r"], a["sign_r"], i))
        assert ok[i].tolist() == [int(pa is not None and pr is not None)] * 4, i
        if pr is not None:
            x, y = pr
            want = [(y + x) % P, (y - x) % P, 2, (-2 * d * x * y) % P]
            assert [value(v.tolist()) for v in nr[i]] == want, i
        if pa is not None:
            x, y = pa
            want = [(y - x) % P, (y + x) % P, 2, (2 * d * x * y) % P]
            assert [value(v.tolist()) for v in na[i]] == want, i
        decoded += pa is not None and pr is not None
    assert 0 < decoded < n


@pytest.mark.parametrize("kernel", ["verify_cached", "verify8_cached",
                                    "verify_uncached", "verify8_uncached"])
def test_quad_kernel_matches_plain_in_emulation(tmp_path, kernel):
    """K1-K4 as written for the card, every thread a fiber, on the edge
    lanes (the last 8-lane block ragged) against their plain versions and
    the oracle. K2 and K4 read scattered arena slots, one out of range; K1
    and K3 decompress A themselves and build its table in shared memory."""
    lib = _compile(tmp_path, kernel, (CSRC / f"{kernel}.cu").read_text())
    pks, msgs, sigs = _lanes()
    n = len(pks)
    assert n % 8 != 0
    buf, host_ok = tverify.pack_bytes(pks, msgs, sigs)
    flavor = "8" if kernel.startswith("verify8") else "4"
    a = tverify.unpack_on_device(torch.from_numpy(buf), flavor)
    s_key = "s_bytes" if flavor == "8" else "s_nibs"
    rsk = [a["y_r"], a["sign_r"], a[s_key], a["kneg_nibs"]]
    consts = torch.from_numpy(curve.kernel_consts())
    tab8 = ([cuda_verify._base_table8_26(torch.device("cpu"))]
            if flavor == "8" else [])
    want = [ref.verify(pk, m, s) for pk, m, s in zip(pks, msgs, sigs)]
    if kernel.endswith("uncached"):
        plain = (curve.verify_kernel8 if flavor == "8"
                 else curve.verify_kernel)(a["y_a"], a["sign_a"], *rsk)
        ptrs = [a["y_a"], a["sign_a"], *rsk, consts, *tab8]
        fn = lib.ed25519_verify8 if flavor == "8" else lib.ed25519_verify
    else:
        table, tab_ok = curve.build_pubkey_tables(a["y_a"], a["sign_a"])
        slots = 97
        gen = torch.Generator().manual_seed(3)
        slot = torch.randperm(slots - 1, generator=gen)[:n]
        arena = torch.zeros((16, 4, 20, slots), dtype=torch.int32)
        arena[..., slot] = table
        arena_ok = torch.zeros(slots, dtype=torch.bool)
        arena_ok[slot] = tab_ok
        idxs = slot.to(torch.int16)
        idxs[1] = slots + 4
        want[1] = False  # its slot is out of range
        plain = (curve.verify_kernel8_slots if flavor == "8"
                 else curve.verify_kernel_slots)(arena, arena_ok, idxs, *rsk)
        ptrs = [arena, arena_ok, idxs, slots, *rsk, consts, *tab8]
        fn = (lib.ed25519_verify8_cached if flavor == "8"
              else lib.ed25519_verify_cached)
    out = torch.zeros(n, dtype=torch.bool)
    ptrs += [out, n]
    args = [ctypes.c_int(x) if isinstance(x, int) else ctypes.c_void_p(x.data_ptr())
            for x in ptrs]
    assert fn(*args, None) == 0
    assert torch.equal(out, plain)
    assert (out & torch.from_numpy(host_ok)).tolist() == want


# X5's warp ops (csrc/rlc.cu: a point a warp, limb s of a coordinate on
# lane s of its eight) beside the quad ops they stand for, on one point of
# four coordinates: the warp's limbs must be the quad's exactly, so that
# the interval proof above holds for them as it is.
WARP_HARNESS = r"""
namespace {
// ops: 0 mul, 1 add, 2 carry1, 3 double, 4 add a Niels point, 5 to Niels
fd warp_op_fd(int op, const fd& x, const fd& y, const fd& d2, int c) {
  return op == 0 ? d_mul(x, y) : op == 1 ? d_add(x, y)
       : op == 2 ? d_carry(x) : op == 3 ? w_double(x, c)
       : op == 4 ? w_add(x, y, c) : w_to_niels(x, d2, c);
}
fe quad_op_fe(int op, fe x, const fe& y, const fe& d2, int c) {
  if (op == 2) {
    carry1(x);
    return x;
  }
  return op == 0 ? fe_mul(x, y) : op == 1 ? fe_add(x, y)
       : op == 3 ? q_double(x, c) : op == 4 ? q_add(x, y, c)
       : q_to_niels(x, d2, c);
}
}  // namespace
// p, n: four elements of NL limbs (coordinate c, or Niels component c,
// at c NL; n's fourth is also to Niels' 2d); out: the warp's, then the
// quad's
extern "C" int warp_op(int op, const uint32_t* p, const uint32_t* n,
                       uint32_t* warp_out, uint32_t* quad_out) {
  emu::launch(1, 32, [&] {
    const int c = w_c();
    d_st(warp_out + NL * c, warp_op_fd(op, d_ld(p + NL * c),
                                       d_ld(n + NL * c), d_ld(n + 3 * NL), c));
  });
  if (cudaGetLastError()) return 1;
  emu::launch(1, 4, [&] {
    const int c = quad_c();
    fe_st(quad_out + NL * c, quad_op_fe(op, fe_ld(p + NL * c),
                                        fe_ld(n + NL * c), fe_ld(n + 3 * NL),
                                        c));
  });
  return cudaGetLastError();
}
// cols: four sets of 2 NL - 1 columns, set c folded by coordinate c's
// eight lanes (d_fold) and by fold_cols
extern "C" int warp_fold(const uint64_t* cols, uint32_t* warp_out,
                         uint32_t* quad_out) {
  emu::launch(1, 32, [&] {
    const int c = w_c(), s = w_s();
    const uint64_t* k = cols + (2 * NL - 1) * c;
    d_st(warp_out + NL * c, d_fold(k[s], k[s + 8], s < 3 ? k[s + 16] : 0));
  });
  if (cudaGetLastError()) return 1;
  for (int c = 0; c < 4; ++c) {
    uint64_t k[2 * NL - 1];
    for (int i = 0; i < 2 * NL - 1; ++i) k[i] = cols[(2 * NL - 1) * c + i];
    fe_st(quad_out + NL * c, fold_cols(k));
  }
  return 0;
}
"""

WARP_OPS = ["mul", "add", "carry1", "double", "add_niels", "to_niels"]


@pytest.fixture(scope="module")
def warp_ops(tmp_path_factory):
    _gpp()
    lib = _compile(tmp_path_factory.mktemp("warp_ops"), "warp_ops",
                   (CSRC / "rlc.cu").read_text() + WARP_HARNESS)
    lib.warp_op.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4
    lib.warp_fold.argtypes = [ctypes.c_void_p] * 3
    return lib


def _warp_points():
    """(p, n) pairs of four elements each, limbs <= LAZY: every choice of
    coordinates all at LAZY and the rest 0 (each bias path, BIAS_HI's on
    limbs 8 and 9 among them, at its widest), against n alike, its
    complement and all LAZY; limbs 8-9 at LAZY over 0 and the reverse;
    seeded mixes of 0 and LAZY; seeded limbs in [0, LAZY]."""
    rng = np.random.default_rng(20261018)

    def by_mask(mask):
        return [[LAZY if mask >> c & 1 else 0] * NL for c in range(4)]

    pairs = [(by_mask(m), by_mask(k)) for m in range(16)
             for k in (m, 15 - m, 15)]
    hi = [[LAZY if i >= 8 else 0 for i in range(NL)]] * 4
    lo = [[0 if i >= 8 else LAZY for i in range(NL)]] * 4
    pairs += [(hi, lo), (lo, hi), (hi, hi)]
    pairs += [(rng.choice([0, LAZY], (4, NL)).tolist(),
               rng.choice([0, LAZY], (4, NL)).tolist()) for _ in range(16)]
    pairs += [(rng.integers(0, LAZY + 1, (4, NL)).tolist(),
               rng.integers(0, LAZY + 1, (4, NL)).tolist())
              for _ in range(16)]
    return pairs


@pytest.mark.parametrize("op", WARP_OPS)
def test_warp_ops_equal_the_quad_ops_limb_for_limb(warp_ops, op):
    """d_mul, d_add, d_carry, w_double, w_add and w_to_niels give the raw
    limbs of fe_mul, fe_add, carry1, q_double, q_add and q_to_niels on the
    same point (the Niels operand's fourth element as 2d), at the lazy
    extremes and on seeded limbs; mul, add and carry1 also the model's
    (which asserts every width), and carry1 on any uint32 limbs."""
    code = WARP_OPS.index(op)
    pairs = _warp_points()
    if op == "carry1":
        rng = np.random.default_rng(7)
        pairs += [([[2**32 - 1] * NL] * 4, [[0] * NL] * 4)]
        pairs += [(rng.integers(0, 2**32, (4, NL)).tolist(), [[0] * NL] * 4)
                  for _ in range(8)]
    model = {"mul": mul, "add": add}.get(op)
    for k, (p, n) in enumerate(pairs):
        p, n = _arr(p), _arr(n)
        got = np.zeros((2, 4, NL), np.uint32)
        assert warp_ops.warp_op(code, p.ctypes.data, n.ctypes.data,
                                got[0].ctypes.data, got[1].ctypes.data) == 0
        assert got[0].tolist() == got[1].tolist(), (op, k)
        for c in range(4):
            a, b = p[c].tolist(), n[c].tolist()
            if model is not None:
                assert got[0, c].tolist() == model(a, b), (op, k, c)
            elif op == "carry1":
                assert got[0, c].tolist() == carry1(a), (op, k, c)


def test_warp_fold_equals_fold_cols_limb_for_limb(warp_ops):
    """d_fold (the fold of d_mul's columns across eight lanes) gives
    fold_cols' limbs and the model's: every column at 10 LAZY^2 (the
    proof's bound), the products of all-LAZY limbs, columns alternating
    between the bound and 0, and seeded columns below the bound."""
    top = 10 * LAZY * LAZY
    rng = np.random.default_rng(11)
    sets = [[top] * (2 * NL - 1),
            [LAZY * LAZY * min(k + 1, 2 * NL - 1 - k)
             for k in range(2 * NL - 1)],
            [top if k % 2 else 0 for k in range(2 * NL - 1)],
            [0 if k % 2 else top for k in range(2 * NL - 1)]]
    sets += [[int(x) for x in rng.integers(0, top + 1, 2 * NL - 1,
                                           dtype=np.uint64)]
             for _ in range(12)]
    for k in range(0, len(sets), 4):
        cols = np.ascontiguousarray(sets[k:k + 4], dtype=np.uint64)
        got = np.zeros((2, 4, NL), np.uint32)
        assert warp_ops.warp_fold(cols.ctypes.data, got[0].ctypes.data,
                                  got[1].ctypes.data) == 0
        assert got[0].tolist() == got[1].tolist(), k
        for c in range(4):
            assert got[0, c].tolist() == fold_cols(sets[k + c]), (k, c)
