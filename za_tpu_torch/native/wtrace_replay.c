/* Native witness-tape interpreter.
 *
 * Replays the straight-line witness program recorded by
 * compiler/wtrace.py (the za-tpu replacement for the reference's
 * per-proof AST re-interpretation, helper.rs:109) at C speed:
 * 4x64-bit limb arithmetic mod the BN254 scalar field r, CIOS
 * Montgomery multiplication, binary long division for the integer
 * ops.  The Python replay loop measures ~240k constraints/s; this
 * interpreter replaces it in WitnessProgram.replay_values when the
 * shared library is buildable (ctypes, see native/__init__.py) and
 * falls back to Python otherwise.  Semantics mirror
 * wtrace._apply_binop / _apply_unop exactly -- including every error
 * condition, which surfaces as a nonzero return code so the caller
 * can fall back to the interpreter (TraceMismatch semantics).
 *
 * Tape encoding (packed by WitnessProgram._packed):
 *   op[i]  : uint8 opcode (same numbering as wtrace.py)
 *   a0[i]  : int64  first operand node id / const index / input index
 *   a1[i]  : int64  second operand node id / guard-int expected (u64)
 *   a2[i]  : int64  guard payload: cmp*2+expected, expected bool, or
 *            has-expected flag
 * Values are little-endian 4x u64 limbs, always fully reduced mod r.
 */

#include <stdint.h>
#include <string.h>

typedef uint64_t u64;
typedef unsigned __int128 u128;

/* r = 21888242871839275222246405745257275088548364400416034343698204186575808495617 */
static const u64 MOD[4] = {0x43e1f593f0000001ULL, 0x2833e84879b97091ULL,
                           0xb85045b68181585dULL, 0x30644e72e131a029ULL};
static const u64 N0INV = 0xc2e1f593efffffffULL; /* -r^-1 mod 2^64 */
static const u64 RR[4] = {0x1bb8e645ae216da7ULL, 0x53fe3ab1e35c59e3ULL,
                          0x8c49833d53bb8085ULL, 0x0216d0b17f4e44a5ULL};
static const u64 R_MINUS_2[4] = {0x43e1f593efffffffULL,
                                 0x2833e84879b97091ULL,
                                 0xb85045b68181585dULL,
                                 0x30644e72e131a029ULL};

/* opcodes -- keep in sync with compiler/wtrace.py */
enum {
    OP_INPUT = 0, OP_CONST = 1, OP_ADD = 2, OP_SUB = 3, OP_MUL = 4,
    OP_DIV = 5, OP_INTDIV = 6, OP_MOD = 7, OP_SHL = 8, OP_SHR = 9,
    OP_BAND = 10, OP_BOR = 11, OP_BXOR = 12, OP_POW = 13, OP_NEG = 14,
    OP_INV = 15, OP_GUARD_CMP = 16, OP_GUARD_ZERO = 17, OP_GUARD_INT = 18,
};

enum { CMP_LT = 0, CMP_LE = 1, CMP_GT = 2, CMP_GE = 3, CMP_EQ = 4 };

/* error codes (mirrored in native/__init__.py) */
enum {
    RC_OK = 0, RC_GUARD = 1, RC_ARITH = 2, RC_BADOP = 3,
};

static inline int cmp4(const u64 a[4], const u64 b[4]) {
    for (int i = 3; i >= 0; i--) {
        if (a[i] < b[i]) return -1;
        if (a[i] > b[i]) return 1;
    }
    return 0;
}

static inline int is_zero4(const u64 a[4]) {
    return (a[0] | a[1] | a[2] | a[3]) == 0;
}

static inline u64 add4(u64 r[4], const u64 a[4], const u64 b[4]) {
    u128 c = 0;
    for (int i = 0; i < 4; i++) {
        c += (u128)a[i] + b[i];
        r[i] = (u64)c;
        c >>= 64;
    }
    return (u64)c;
}

static inline u64 sub4(u64 r[4], const u64 a[4], const u64 b[4]) {
    u128 bor = 0;
    for (int i = 0; i < 4; i++) {
        u128 d = (u128)a[i] - b[i] - bor;
        r[i] = (u64)d;
        bor = (d >> 64) & 1;
    }
    return (u64)bor;
}

static inline void add_mod(u64 r[4], const u64 a[4], const u64 b[4]) {
    u64 c = add4(r, a, b);
    if (c || cmp4(r, MOD) >= 0) sub4(r, r, MOD);
}

static inline void sub_mod(u64 r[4], const u64 a[4], const u64 b[4]) {
    if (sub4(r, a, b)) add4(r, r, MOD);
}

static inline void neg_mod(u64 r[4], const u64 a[4]) {
    if (is_zero4(a)) { memset(r, 0, 32); return; }
    sub4(r, MOD, a);
}

/* CIOS Montgomery multiply: r = a*b*2^-256 mod MOD (inputs < MOD). */
static void mont_mul(u64 r[4], const u64 a[4], const u64 b[4]) {
    u64 t[6] = {0, 0, 0, 0, 0, 0};
    for (int i = 0; i < 4; i++) {
        u128 c = 0;
        for (int j = 0; j < 4; j++) {
            c += (u128)t[j] + (u128)a[j] * b[i];
            t[j] = (u64)c;
            c >>= 64;
        }
        c += t[4];
        t[4] = (u64)c;
        t[5] = (u64)(c >> 64);

        u64 m = t[0] * N0INV;
        c = (u128)t[0] + (u128)m * MOD[0];
        c >>= 64;
        for (int j = 1; j < 4; j++) {
            c += (u128)t[j] + (u128)m * MOD[j];
            t[j - 1] = (u64)c;
            c >>= 64;
        }
        c += t[4];
        t[3] = (u64)c;
        t[4] = t[5] + (u64)(c >> 64);
        t[5] = 0;
    }
    if (t[4] || cmp4(t, MOD) >= 0) sub4(t, t, MOD);
    memcpy(r, t, 32);
}

/* plain a*b mod r via two Montgomery multiplies */
static inline void mul_mod(u64 r[4], const u64 a[4], const u64 b[4]) {
    u64 t[4];
    mont_mul(t, a, b);
    mont_mul(r, t, RR);
}

/* r = a^e mod MOD, e a 4-limb plain exponent; a plain, r plain. */
static void pow_mod(u64 r[4], const u64 a[4], const u64 e[4]) {
    u64 am[4], acc[4];
    mont_mul(am, a, RR);              /* to Montgomery */
    /* acc = 1 in Montgomery form = 2^256 mod r = mont(1, RR) */
    static const u64 ONE[4] = {1, 0, 0, 0};
    mont_mul(acc, ONE, RR);
    int top = 255;
    while (top >= 0 && !((e[top >> 6] >> (top & 63)) & 1)) top--;
    for (int i = top; i >= 0; i--) {
        mont_mul(acc, acc, acc);
        if ((e[i >> 6] >> (i & 63)) & 1) mont_mul(acc, acc, am);
    }
    mont_mul(r, acc, ONE);            /* from Montgomery */
}

static void pow_mod_u64(u64 r[4], const u64 a[4], u64 e) {
    u64 e4[4] = {e, 0, 0, 0};
    pow_mod(r, a, e4);
}

/* 0 on success; RC_ARITH when a not invertible (== 0 mod r) */
static int inv_mod(u64 r[4], const u64 a[4]) {
    if (is_zero4(a)) return RC_ARITH;
    pow_mod(r, a, R_MINUS_2);
    return RC_OK;
}

static void shr_bits(u64 r[4], const u64 a[4], u64 k) {
    if (k >= 256) { memset(r, 0, 32); return; }
    u64 t[4];
    memcpy(t, a, 32);
    u64 w = k >> 6, b = k & 63;
    for (int i = 0; i < 4; i++) {
        u64 lo = (i + (int)w < 4) ? t[i + w] : 0;
        u64 hi = (i + (int)w + 1 < 4) ? t[i + w + 1] : 0;
        r[i] = b ? (lo >> b) | (hi << (64 - b)) : lo;
    }
}

/* (a << k) mod r == a * 2^k mod r for every k (python parity) */
static void shl_mod(u64 r[4], const u64 a[4], u64 k) {
    u64 p2[4];
    static const u64 TWO[4] = {2, 0, 0, 0};
    pow_mod_u64(p2, TWO, k);
    mul_mod(r, a, p2);
}

/* 256-bit integer divmod (binary long division; rare tape ops) */
static void divmod4(u64 q[4], u64 rem[4], const u64 a[4], const u64 b[4]) {
    memset(q, 0, 32);
    memset(rem, 0, 32);
    for (int i = 255; i >= 0; i--) {
        /* rem = (rem << 1) | bit_i(a) */
        for (int j = 3; j > 0; j--)
            rem[j] = (rem[j] << 1) | (rem[j - 1] >> 63);
        rem[0] = (rem[0] << 1) | ((a[i >> 6] >> (i & 63)) & 1);
        if (cmp4(rem, b) >= 0) {
            sub4(rem, rem, b);
            q[i >> 6] |= 1ULL << (i & 63);
        }
    }
}

/* bitwise results can reach 2^254 > r: one conditional subtract */
static inline void reduce_once(u64 r[4]) {
    if (cmp4(r, MOD) >= 0) sub4(r, r, MOD);
}

int za_wtrace_replay(
    int64_t n,
    const uint8_t *op,
    const int64_t *a0,
    const int64_t *a1,
    const int64_t *a2,
    const u64 *consts,   /* nconst x 4 limbs */
    const u64 *inputs,   /* ninput x 4 limbs */
    u64 *vals,           /* n x 4 limbs out */
    int64_t *err_idx)
{
    for (int64_t i = 0; i < n; i++) {
        u64 *v = vals + 4 * i;
        int o = op[i];
        switch (o) {
        case OP_INPUT:
            memcpy(v, inputs + 4 * a0[i], 32);
            break;
        case OP_CONST:
            memcpy(v, consts + 4 * a0[i], 32);
            break;
        case OP_ADD:
            add_mod(v, vals + 4 * a0[i], vals + 4 * a1[i]);
            break;
        case OP_SUB:
            sub_mod(v, vals + 4 * a0[i], vals + 4 * a1[i]);
            break;
        case OP_MUL:
            mul_mod(v, vals + 4 * a0[i], vals + 4 * a1[i]);
            break;
        case OP_DIV: {
            u64 binv[4];
            if (inv_mod(binv, vals + 4 * a1[i])) {
                *err_idx = i;
                return RC_ARITH;
            }
            mul_mod(v, vals + 4 * a0[i], binv);
            break;
        }
        case OP_INTDIV:
        case OP_MOD: {
            const u64 *b = vals + 4 * a1[i];
            if (is_zero4(b)) { *err_idx = i; return RC_ARITH; }
            u64 q[4], rem[4];
            divmod4(q, rem, vals + 4 * a0[i], b);
            memcpy(v, o == OP_INTDIV ? q : rem, 32);
            break;
        }
        case OP_SHL:
        case OP_SHR: {
            const u64 *b = vals + 4 * a1[i];
            if (b[1] | b[2] | b[3]) { *err_idx = i; return RC_ARITH; }
            if (o == OP_SHL)
                shl_mod(v, vals + 4 * a0[i], b[0]);
            else
                shr_bits(v, vals + 4 * a0[i], b[0]);
            break;
        }
        case OP_BAND:
        case OP_BOR:
        case OP_BXOR: {
            const u64 *x = vals + 4 * a0[i];
            const u64 *y = vals + 4 * a1[i];
            for (int j = 0; j < 4; j++)
                v[j] = o == OP_BAND ? (x[j] & y[j])
                     : o == OP_BOR ? (x[j] | y[j]) : (x[j] ^ y[j]);
            reduce_once(v);
            break;
        }
        case OP_POW:
            pow_mod(v, vals + 4 * a0[i], vals + 4 * a1[i]);
            break;
        case OP_NEG:
            neg_mod(v, vals + 4 * a0[i]);
            break;
        case OP_INV:
            if (inv_mod(v, vals + 4 * a0[i])) {
                *err_idx = i;
                return RC_ARITH;
            }
            break;
        case OP_GUARD_CMP: {
            int c = cmp4(vals + 4 * a0[i], vals + 4 * a1[i]);
            int which = (int)(a2[i] >> 1), expect = (int)(a2[i] & 1);
            int got;
            switch (which) {
            case CMP_LT: got = c < 0; break;
            case CMP_LE: got = c <= 0; break;
            case CMP_GT: got = c > 0; break;
            case CMP_GE: got = c >= 0; break;
            default: got = c == 0; break;
            }
            if (got != expect) { *err_idx = i; return RC_GUARD; }
            break;
        }
        case OP_GUARD_ZERO:
            if (is_zero4(vals + 4 * a0[i]) != (int)(a2[i] & 1)) {
                *err_idx = i;
                return RC_GUARD;
            }
            break;
        case OP_GUARD_INT: {
            const u64 *x = vals + 4 * a0[i];
            int fits = !(x[1] | x[2] | x[3]);
            int has = (int)(a2[i] & 1);
            if (fits != has || (fits && x[0] != (u64)a1[i])) {
                *err_idx = i;
                return RC_GUARD;
            }
            break;
        }
        default:
            *err_idx = i;
            return RC_BADOP;
        }
    }
    return RC_OK;
}
