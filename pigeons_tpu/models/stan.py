"""Real ``.stan`` ingestion: a Stan-subset front end compiled to JAX.

The reference's flagship external frontend compiles ``.stan`` files through
BridgeStan and ``ccall``s the generated C++ (``ext/PigeonsBridgeStanExt/
interface.jl:120-183``; custom serializer ``:34-49``; ``param_constrain``
incl. transformed params/generated quantities ``state.jl:4-8``). The
batched equivalent cannot call per-point C++ from inside a vmapped kernel
without destroying batching, so this module COMPILES the Stan model language
itself into traced JAX functions: one ``log_density(x_unconstrained)``
(``propto=false`` + change-of-variables jacobian, exactly BridgeStan's
convention, so normalization constants are correct) that the runtime vmaps
over all replicas and differentiates with ``jax.grad`` for AutoMALA — the
reference's default explorer for Stan targets (``interface.jl:51``).

Supported language (covers every model in the reference's ``examples/stan/``
plus the constrained-container hierarchy of applied Stan):

* blocks: ``functions``, ``data``, ``transformed data``, ``parameters``,
  ``transformed parameters``, ``model``, ``generated quantities``;
* types: ``int``, ``real``, ``vector[n]``, ``row_vector[n]``,
  ``matrix[m,n]`` with ``<lower=..., upper=...>`` constraints (Stan's
  exp / scaled-logit transforms with jacobian), the constrained containers
  ``simplex``, ``ordered``, ``positive_ordered``, ``unit_vector``,
  ``corr_matrix``, ``cov_matrix``, ``cholesky_factor_corr``,
  ``cholesky_factor_cov`` (Stan reference manual ch. 10 transforms, each
  jacobian verified against the autodiff slogdet oracle in
  tests/test_stan_lang.py), and ``array[...]`` of any of these;
* statements: declarations (with initializers and comma lists), assignment
  (``=``, ``+=``, ``-=``, ``*=``, ``/=``), ``target +=``, vectorized ``~``
  sampling statements, ``for (i in a:b)``, ``while``, ``break``,
  ``continue`` (loops run at trace time — bounds/conditions are data; pure
  data-likelihood ``for`` loops auto-vectorize so trace time stays O(1) in
  the data length), ``if``/``else`` with early ``return`` (compiled to
  ``where`` blending so traced conditions work), ternaries, user-defined
  functions;
* densities (all with their normalizing constants, as ``propto=false``):
  normal, std_normal, cauchy, beta, bernoulli(+_logit), binomial, uniform,
  exponential, lognormal, student_t, gamma, inv_gamma, poisson,
  double_exponential, logistic, chi_square, weibull, pareto,
  neg_binomial_2, von_mises + the multivariate family — multi_normal
  (+_cholesky, _prec), dirichlet, lkj_corr(+_cholesky) with the exact LKJ
  normalizer, categorical(+_logit), multinomial, wishart, inv_wishart —
  and their ``_lpdf``/``_lpmf`` call forms;
* operators: Stan ``*`` is matrix algebra (matmul/dot/outer via the
  row/column syntax), ``.*``/``./`` elementwise, ``\\`` left-division,
  int ``/`` and ``%`` with C truncation semantics; range indexing
  ``x[a:b]``, row/column slices, integer-array gathers (``beta[g]``);
* math/matrix builtins: the scalar library plus ``rep_matrix diag_matrix
  diagonal identity_matrix cholesky_decompose inverse determinant
  log_determinant trace quad_form(_diag,_sym) diag_pre_multiply
  diag_post_multiply multiply_lower_tri_self_transpose crossprod tcrossprod
  mdivide_left(_tri_low) mdivide_right(_tri_low) dot_product
  rows_dot_product columns_dot_product to_vector to_matrix col row head
  tail segment append_row append_col softmax log_softmax cumulative_sum
  sort_asc sort_desc sd variance prod distance norm1 norm2`` ...;
* generated quantities ``*_rng`` functions (host-side extraction only).

Deviations from BridgeStan (documented):
* ``default_reference`` is the standard normal on the UNCONSTRAINED space
  (iid-sampleable, normalized — so stepping-stone logZ equals the marginal
  likelihood). The reference uses the target itself (``interface.jl:86``),
  which makes the annealing path degenerate unless the user supplies a
  reference; passing ``reference=...`` or ``variational=...`` works here too.
* loops run at trace time (auto-vectorized for pure data-likelihood bodies,
  unrolled otherwise), so loop bounds must be data; parameter-dependent
  ``while`` conditions fail loudly.
* matrix containers serialize unconstrained coordinates in row-major
  (diag-first for cov/cholesky) order rather than BridgeStan's column-major;
  only our own sample_array/checkpoint layouts observe this.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .target import Reference, Target

# ---------------------------------------------------------------------------
# tokenizer
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
    (?P<comment>//[^\n]*|\#[^\n]*|/\*.*?\*/)
  | (?P<str>"[^"\n]*")
  | (?P<num>((\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?))
  | (?P<name>[A-Za-z_][A-Za-z0-9_]*)
  | (?P<op>\.\*|\./|<=|>=|==|!=|\+=|-=|\*=|/=|&&|\|\||[-+*/^<>=!?:;,(){}\[\]|~%.'\\])
  | (?P<ws>\s+)
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(src: str):
    tokens = []
    pos = 0
    while pos < len(src):
        m = _TOKEN_RE.match(src, pos)
        if m is None:
            raise SyntaxError(f"stan: cannot tokenize at: {src[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup in ("comment", "ws"):
            continue
        tokens.append((m.lastgroup, m.group()))
    tokens.append(("eof", ""))
    return tokens


# ---------------------------------------------------------------------------
# parser -> tuple AST
# ---------------------------------------------------------------------------

_BLOCKS = (
    "functions",
    "data",
    "transformed data",
    "parameters",
    "transformed parameters",
    "model",
    "generated quantities",
)

_TYPES = ("int", "real", "vector", "row_vector", "matrix", "array", "void")

# constrained container types (Stan reference manual ch. 10 transforms)
_SPECIAL_VEC = ("simplex", "ordered", "positive_ordered", "unit_vector")
_SPECIAL_MAT = (
    "cov_matrix",
    "corr_matrix",
    "cholesky_factor_corr",
    "cholesky_factor_cov",
)
_TYPE_KEYWORDS = (
    "int",
    "real",
    "vector",
    "row_vector",
    "matrix",
    "array",
) + _SPECIAL_VEC + _SPECIAL_MAT


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self, k=0):
        return self.toks[self.i + k]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, val):
        t = self.next()
        if t[1] != val:
            raise SyntaxError(f"stan: expected {val!r}, got {t[1]!r}")
        return t

    def accept(self, val):
        if self.peek()[1] == val:
            self.next()
            return True
        return False

    # -- program ---------------------------------------------------------

    def parse_program(self):
        blocks = {}
        while self.peek()[0] != "eof":
            name = self.next()[1]
            if name == "transformed" or name == "generated":
                name = name + " " + self.next()[1]
            if name not in _BLOCKS:
                raise SyntaxError(f"stan: unknown block {name!r}")
            self.expect("{")
            if name == "functions":
                blocks[name] = self.parse_functions()
            elif name in ("data", "parameters"):
                blocks[name] = self.parse_decls_only()
            else:
                blocks[name] = self.parse_stmts()
            self.expect("}")
        return blocks

    def parse_functions(self):
        funcs = []
        while self.peek()[1] != "}":
            ret_type = self.next()[1]
            name = self.next()[1]
            self.expect("(")
            params = []
            while self.peek()[1] != ")":
                ptype = self.next()[1]
                if ptype == "array":  # array[] real x
                    self.expect("[")
                    while self.peek()[1] != "]":
                        self.next()
                    self.expect("]")
                    ptype = "array " + self.next()[1]
                pname = self.next()[1]
                params.append((ptype, pname))
                if self.peek()[1] == ",":
                    self.next()
            self.expect(")")
            self.expect("{")
            body = self.parse_stmts()
            self.expect("}")
            funcs.append((name, ret_type, params, body))
        return funcs

    def parse_decls_only(self):
        decls = []
        while self.peek()[1] != "}":
            decls.extend(self.parse_decl())
        return decls

    # -- declarations ----------------------------------------------------

    def _parse_constraint(self):
        lower = upper = None
        if self.accept("<"):
            while True:
                kind = self.next()[1]
                self.expect("=")
                # additive precedence: ">" must close the constraint, not
                # parse as a comparison
                e = self.parse_add()
                if kind == "lower":
                    lower = e
                elif kind == "upper":
                    upper = e
                else:
                    raise SyntaxError(f"stan: unsupported constraint {kind!r}")
                if not self.accept(","):
                    break
            self.expect(">")
        return lower, upper

    def _parse_type(self):
        """One (possibly array-of-container) type spec ->
        ``(kind, array_dims, elem_dims, lower, upper)``."""
        base = self.next()[1]
        array_dims = []
        if base == "array":
            self.expect("[")
            array_dims.append(self.parse_expr())
            while self.accept(","):
                array_dims.append(self.parse_expr())
            self.expect("]")
            base = self.next()[1]
        lower = upper = None
        elem_dims = []
        if base in ("int", "real"):
            lower, upper = self._parse_constraint()
        elif base in ("vector", "row_vector"):
            lower, upper = self._parse_constraint()
            self.expect("[")
            elem_dims.append(self.parse_expr())
            self.expect("]")
        elif base == "matrix":
            lower, upper = self._parse_constraint()
            self.expect("[")
            elem_dims.append(self.parse_expr())
            self.expect(",")
            elem_dims.append(self.parse_expr())
            self.expect("]")
        elif base in _SPECIAL_VEC:
            self.expect("[")
            elem_dims.append(self.parse_expr())
            self.expect("]")
        elif base in _SPECIAL_MAT:
            self.expect("[")
            elem_dims.append(self.parse_expr())
            if self.accept(","):
                elem_dims.append(self.parse_expr())
            self.expect("]")
        else:
            raise SyntaxError(f"stan: unsupported type {base!r}")
        return base, tuple(array_dims), tuple(elem_dims), lower, upper

    def parse_decl(self):
        """One declaration statement, possibly with multiple names and
        initializers; returns a list of ('decl', name, kind, array_dims,
        elem_dims, lower, upper, init) nodes."""
        kind, adims, edims, lower, upper = self._parse_type()
        out = []
        while True:
            name = self.next()[1]
            init = None
            if self.accept("="):
                init = self.parse_expr()
            out.append(("decl", name, kind, adims, edims, lower, upper, init))
            if not self.accept(","):
                break
        self.expect(";")
        return out

    # -- statements ------------------------------------------------------

    def parse_stmts(self):
        stmts = []
        while self.peek()[1] not in ("}",) and self.peek()[0] != "eof":
            stmts.extend(self.parse_stmt())
        return stmts

    def parse_stmt(self):
        t = self.peek()
        v = t[1]
        if v == "{":
            self.next()
            body = self.parse_stmts()
            self.expect("}")
            return [("block", body)]
        if v == "for":
            self.next()
            self.expect("(")
            var = self.next()[1]
            self.expect("in")
            lo = self.parse_expr()
            self.expect(":")
            hi = self.parse_expr()
            self.expect(")")
            body = self.parse_stmt()
            return [("for", var, lo, hi, body)]
        if v == "while":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            body = self.parse_stmt()
            return [("while", cond, body)]
        if v == "break":
            self.next()
            self.expect(";")
            return [("break",)]
        if v == "continue":
            self.next()
            self.expect(";")
            return [("continue",)]
        if v == "if":
            self.next()
            self.expect("(")
            cond = self.parse_expr()
            self.expect(")")
            then = self.parse_stmt()
            other = []
            if self.accept("else"):
                other = self.parse_stmt()
            return [("if", cond, then, other)]
        if v == "return":
            self.next()
            e = None
            if self.peek()[1] != ";":
                e = self.parse_expr()
            self.expect(";")
            return [("return", e)]
        if v in ("print", "reject"):
            self.next()
            depth = 0
            while not (depth == 0 and self.peek()[1] == ";"):
                tv = self.next()[1]
                depth += tv == "("
                depth -= tv == ")"
            self.expect(";")
            # print is a no-op; reject() zeroes the density (Stan: the draw
            # is rejected — in a density evaluation that is target = -inf)
            return [("reject",)] if v == "reject" else [("nop",)]
        if v == "target":
            self.next()
            self.expect("+=")
            e = self.parse_expr()
            self.expect(";")
            return [("target", e)]
        # declaration? (type keywords are reserved words in Stan)
        if v in _TYPE_KEYWORDS and self.peek(1)[1] != "(":
            return self.parse_decl()
        # expression statement: lvalue op expr | expr ~ dist(...)
        e = self.parse_expr()
        nxt = self.next()[1]
        if nxt == "~":
            dist = self.next()[1]
            self.expect("(")
            args = self.parse_args(")")
            # optional truncation T[a, b] / T[a, ] / T[, b]
            trunc = None
            if self.peek()[1] == "T":
                self.next()
                self.expect("[")
                lo = None if self.peek()[1] == "," else self.parse_expr()
                self.expect(",")
                hi = None if self.peek()[1] == "]" else self.parse_expr()
                self.expect("]")
                trunc = (lo, hi)
            self.expect(";")
            return [("sample", e, dist, args, trunc)]
        if nxt in ("=", "+=", "-=", "*=", "/="):
            rhs = self.parse_expr()
            self.expect(";")
            return [("assign", e, nxt, rhs)]
        if nxt == ";":
            return [("nop",)]
        raise SyntaxError(f"stan: unexpected {nxt!r} after expression")

    def parse_args(self, closer):
        args = []
        if self.peek()[1] != closer:
            args.append(self.parse_expr())
            while self.peek()[1] in (",", "|"):
                self.next()
                args.append(self.parse_expr())
        self.expect(closer)
        return args

    # -- expressions -----------------------------------------------------

    def parse_expr(self):
        return self.parse_ternary()

    def parse_ternary(self):
        c = self.parse_or()
        if self.accept("?"):
            a = self.parse_expr()
            self.expect(":")
            b = self.parse_expr()
            return ("ternary", c, a, b)
        return c

    def parse_or(self):
        e = self.parse_and()
        while self.accept("||"):
            e = ("or", e, self.parse_and())
        return e

    def parse_and(self):
        e = self.parse_cmp()
        while self.accept("&&"):
            e = ("and", e, self.parse_cmp())
        return e

    def parse_cmp(self):
        e = self.parse_add()
        while self.peek()[1] in ("<", "<=", ">", ">=", "==", "!="):
            op = self.next()[1]
            e = ("cmp", op, e, self.parse_add())
        return e

    def parse_add(self):
        e = self.parse_mul()
        while self.peek()[1] in ("+", "-"):
            op = self.next()[1]
            e = ("bin", op, e, self.parse_mul())
        return e

    def parse_mul(self):
        e = self.parse_unary()
        while self.peek()[1] in ("*", "/", "%", ".*", "./", "\\"):
            op = self.next()[1]
            e = ("bin", op, e, self.parse_unary())
        return e

    def parse_unary(self):
        if self.peek()[1] in ("-", "+", "!"):
            op = self.next()[1]
            return ("unary", op, self.parse_unary())
        return self.parse_pow()

    def parse_pow(self):
        e = self.parse_postfix()
        if self.accept("^"):
            return ("bin", "^", e, self.parse_unary())
        return e

    def parse_postfix(self):
        t = self.next()
        if t[1] == "(":
            e = self.parse_expr()
            self.expect(")")
        elif t[0] == "num":
            v = t[1]
            e = ("num", int(v) if re.fullmatch(r"\d+", v) else float(v))
        elif t[0] == "name":
            if self.peek()[1] == "(":
                self.next()
                args = self.parse_args(")")
                e = ("call", t[1], args)
            else:
                e = ("var", t[1])
        else:
            raise SyntaxError(f"stan: unexpected token {t[1]!r}")
        while self.peek()[1] == "[":
            self.next()
            idx = [self.parse_index_item()]
            while self.accept(","):
                idx.append(self.parse_index_item())
            self.expect("]")
            e = ("index", e, tuple(idx))
        if self.accept("'"):
            e = ("transpose", e)
        return e

    def parse_index_item(self):
        """One multi-index item: expr | expr:expr | expr: | :expr | :
        (Stan range indexing, reference manual 'multiple indexing')."""
        if self.peek()[1] == ":":
            self.next()
            if self.peek()[1] in (",", "]"):
                return ("irange", None, None)
            return ("irange", None, self.parse_expr())
        e = self.parse_expr()
        if self.accept(":"):
            if self.peek()[1] in (",", "]"):
                return ("irange", e, None)
            return ("irange", e, self.parse_expr())
        return e


# ---------------------------------------------------------------------------
# densities (full constants: propto=false, matching the reference's choice
# "to get correct log normalization constants", interface.jl:64-69)
# ---------------------------------------------------------------------------

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


def _lpdf_normal(y, mu, sigma):
    return -0.5 * ((y - mu) / sigma) ** 2 - jnp.log(sigma) - _HALF_LOG_2PI


def _lpdf_cauchy(y, mu, sigma):
    return -jnp.log(math.pi * sigma * (1.0 + ((y - mu) / sigma) ** 2))


def _lpdf_beta(y, a, b):
    lbeta = (
        jax.lax.lgamma(1.0 * a) + jax.lax.lgamma(1.0 * b) - jax.lax.lgamma(1.0 * (a + b))
    )
    return (a - 1.0) * jnp.log(y) + (b - 1.0) * jnp.log1p(-y) - lbeta


def _lpmf_bernoulli(y, theta):
    return y * jnp.log(theta) + (1.0 - y) * jnp.log1p(-theta)


def _lpmf_binomial(n, N, p):
    lchoose = (
        jax.lax.lgamma(1.0 + N) - jax.lax.lgamma(1.0 + n) - jax.lax.lgamma(1.0 + N - n)
    )
    return lchoose + n * jnp.log(p) + (N - n) * jnp.log1p(-p)


def _lpdf_uniform(y, a, b):
    inside = (y >= a) & (y <= b)
    return jnp.where(inside, -jnp.log(b - a), -jnp.inf)


def _lpdf_exponential(y, rate):
    return jnp.log(rate) - rate * y


def _lpdf_lognormal(y, mu, sigma):
    return _lpdf_normal(jnp.log(y), mu, sigma) - jnp.log(y)


def _lpdf_student_t(y, nu, mu, sigma):
    z = (y - mu) / sigma
    return (
        jax.lax.lgamma((nu + 1.0) / 2.0)
        - jax.lax.lgamma(nu / 2.0)
        - 0.5 * jnp.log(nu * math.pi)
        - jnp.log(sigma)
        - (nu + 1.0) / 2.0 * jnp.log1p(z * z / nu)
    )


def _lpdf_gamma(y, alpha, beta):
    return (
        alpha * jnp.log(beta)
        - jax.lax.lgamma(1.0 * alpha)
        + (alpha - 1.0) * jnp.log(y)
        - beta * y
    )


def _lpdf_inv_gamma(y, alpha, beta):
    return (
        alpha * jnp.log(beta)
        - jax.lax.lgamma(1.0 * alpha)
        - (alpha + 1.0) * jnp.log(y)
        - beta / y
    )


def _lpmf_poisson(k, lam):
    return k * jnp.log(lam) - lam - jax.lax.lgamma(k + 1.0)


def _lpdf_double_exponential(y, mu, sigma):
    return -jnp.abs(y - mu) / sigma - jnp.log(2.0 * sigma)


def _lpdf_logistic(y, mu, sigma):
    z = (y - mu) / sigma
    return -z - jnp.log(sigma) - 2.0 * jax.nn.softplus(-z)


def _lpdf_chi_square(y, nu):
    return (
        (0.5 * nu - 1.0) * jnp.log(y)
        - 0.5 * y
        - 0.5 * nu * math.log(2.0)
        - jax.lax.lgamma(0.5 * nu)
    )


def _lpdf_weibull(y, alpha, sigma):
    z = y / sigma
    return jnp.log(alpha / sigma) + (alpha - 1.0) * jnp.log(z) - z**alpha


def _lpdf_pareto(y, y_min, alpha):
    return jnp.log(alpha) + alpha * jnp.log(y_min) - (alpha + 1.0) * jnp.log(y)


def _lpmf_neg_binomial_2(n, mu, phi):
    lchoose = (
        jax.lax.lgamma(n + phi)
        - jax.lax.lgamma(n + 1.0)
        - jax.lax.lgamma(1.0 * phi)
    )
    return (
        lchoose
        + n * (jnp.log(mu) - jnp.log(mu + phi))
        + phi * (jnp.log(phi) - jnp.log(mu + phi))
    )


def _lpmf_poisson_log(k, alpha):
    return k * alpha - jnp.exp(alpha) - jax.lax.lgamma(k + 1.0)


def _lpmf_binomial_logit(n, N, alpha):
    lchoose = (
        jax.lax.lgamma(1.0 + N) - jax.lax.lgamma(1.0 + n) - jax.lax.lgamma(1.0 + N - n)
    )
    return lchoose + n * jax.nn.log_sigmoid(alpha) + (N - n) * jax.nn.log_sigmoid(-alpha)


def _lpmf_neg_binomial_2_log(n, eta, phi):
    # mu = exp(eta); log(mu + phi) = logaddexp(eta, log phi), fully in logs
    lse = jnp.logaddexp(eta, jnp.log(phi))
    lchoose = (
        jax.lax.lgamma(n + phi)
        - jax.lax.lgamma(n + 1.0)
        - jax.lax.lgamma(1.0 * phi)
    )
    return lchoose + n * (eta - lse) + phi * (jnp.log(phi) - lse)


def _ordered_interval_logprob(a_log_upper, b_log_upper):
    """log(exp(a) - exp(b)) for log-CDF-style upper tails a >= b, with
    b = -inf handled exactly (gradient-safe)."""
    neg = jnp.isneginf(b_log_upper)
    diff = jnp.where(neg, 1.0, -jnp.expm1(b_log_upper - a_log_upper))
    return a_log_upper + jnp.log(diff)


def _lpmf_ordered_logistic(y, eta, c):
    """y in 1..K with K-1 ordered cutpoints (Stan functions reference):
    P(y=k) = sigmoid(eta - c_{k-1}) - sigmoid(eta - c_k), c_0 = -inf,
    c_K = +inf. Vectorizes over arrays of (y, eta)."""
    c = jnp.asarray(c)
    y = jnp.asarray(y, jnp.int32).reshape(-1)
    eta = jnp.broadcast_to(
        jnp.asarray(eta, jnp.result_type(c, float)).reshape(-1), y.shape
    )
    big = jnp.asarray([jnp.inf], c.dtype)
    c_ext = jnp.concatenate([-big, c, big])
    a = jax.nn.log_sigmoid(eta - c_ext[y - 1])  # log upper-tail at c_{k-1}
    b = jax.nn.log_sigmoid(eta - c_ext[y])  # log upper-tail at c_k
    return jnp.sum(_ordered_interval_logprob(a, b))


def _lpmf_ordered_probit(y, eta, c):
    c = jnp.asarray(c)
    y = jnp.asarray(y, jnp.int32).reshape(-1)
    eta = jnp.broadcast_to(
        jnp.asarray(eta, jnp.result_type(c, float)).reshape(-1), y.shape
    )
    big = jnp.asarray([jnp.inf], c.dtype)
    c_ext = jnp.concatenate([-big, c, big])
    # upper tail 1 - Phi(c - eta) = Phi(eta - c)
    a = jax.scipy.stats.norm.logcdf(eta - c_ext[y - 1])
    b = jax.scipy.stats.norm.logcdf(eta - c_ext[y])
    return jnp.sum(_ordered_interval_logprob(a, b))


def _lpdf_von_mises(y, mu, kappa):
    # log I0 via the exponentially-scaled Bessel: log(i0e) + kappa
    log_i0 = jnp.log(jax.scipy.special.i0e(kappa)) + kappa
    return kappa * jnp.cos(y - mu) - math.log(2.0 * math.pi) - log_i0


# -- multivariate densities (match Stan's normalization, propto=false) ------


def _betaln(a, b):
    return (
        jax.lax.lgamma(1.0 * a)
        + jax.lax.lgamma(1.0 * b)
        - jax.lax.lgamma(1.0 * (a + b))
    )


def _rows_of(y, K):
    """View y as [n_rows, K] (Stan vectorizes multivariate densities over
    arrays of vectors)."""
    y = jnp.asarray(y)
    return y.reshape(-1, K)


def _lpdf_multi_normal_cholesky(y, mu, L):
    K = L.shape[-1]
    ys = _rows_of(y, K)
    mus = jnp.broadcast_to(jnp.asarray(mu, ys.dtype).reshape(-1, K), ys.shape)
    z = jax.scipy.linalg.solve_triangular(L, (ys - mus).T, lower=True)
    n = ys.shape[0]
    return (
        -0.5 * jnp.sum(z * z)
        - n * jnp.sum(jnp.log(jnp.diagonal(L)))
        - 0.5 * n * K * math.log(2.0 * math.pi)
    )


def _lpdf_multi_normal(y, mu, Sigma):
    return _lpdf_multi_normal_cholesky(y, mu, jnp.linalg.cholesky(Sigma))


def _lpdf_multi_normal_prec(y, mu, Omega):
    K = Omega.shape[-1]
    ys = _rows_of(y, K)
    mus = jnp.broadcast_to(jnp.asarray(mu, ys.dtype).reshape(-1, K), ys.shape)
    d = ys - mus
    n = ys.shape[0]
    sign, logdet = jnp.linalg.slogdet(Omega)
    quad = jnp.sum(d * (d @ Omega))
    return -0.5 * quad + 0.5 * n * logdet - 0.5 * n * K * math.log(2.0 * math.pi)


def _lpdf_dirichlet(theta, alpha):
    alpha = jnp.asarray(alpha, jnp.result_type(theta, float))
    return (
        jnp.sum((alpha - 1.0) * jnp.log(theta))
        + jax.lax.lgamma(jnp.sum(alpha))
        - jnp.sum(jax.lax.lgamma(alpha))
    )


def _lkj_log_norm(K, eta):
    """log of the LKJ normalizing constant c_K(eta): the density over
    correlation matrices is c * det(R)^(eta-1). Via the C-vine construction
    (Lewandowski-Kurowicka-Joe): the canonical partial correlations of row i
    are iid scaled Beta(b_i, b_i) on (-1, 1) with b_i = eta + (K-1-i)/2, so
    c is the product of those (2^(2b-1) B(b,b))^-1 normalizers. Verified by
    quadrature/Monte-Carlo normalization tests (tests/test_stan_lang.py)."""
    total = 0.0
    for i in range(1, K):
        b = eta + (K - 1 - i) / 2.0
        total = total - (K - i) * (
            (2.0 * b - 1.0) * math.log(2.0) + _betaln(b, b)
        )
    return total


def _lpdf_lkj_corr_cholesky(L, eta):
    K = L.shape[-1]
    k = jnp.arange(1, K + 1)
    pw = K - k + 2.0 * eta - 2.0  # exponent of L_kk (Stan math lkj_corr_cholesky)
    diag = jnp.diagonal(L)
    lp = jnp.sum(pw[1:] * jnp.log(diag[1:]))
    return lp + _lkj_log_norm(K, eta)


def _lpdf_lkj_corr(R, eta):
    K = R.shape[-1]
    sign, logdet = jnp.linalg.slogdet(R)
    return (eta - 1.0) * logdet + _lkj_log_norm(K, eta)


def _lpmf_categorical(y, theta):
    yi = jnp.asarray(y, jnp.int32) - 1
    return jnp.sum(jnp.log(theta)[yi])


def _lpmf_categorical_logit(y, beta):
    yi = jnp.asarray(y, jnp.int32) - 1
    return jnp.sum(jax.nn.log_softmax(beta)[yi])


def _lpmf_multinomial(y, theta):
    y = jnp.asarray(y)
    return (
        jax.lax.lgamma(jnp.sum(y) + 1.0)
        - jnp.sum(jax.lax.lgamma(y + 1.0))
        + jnp.sum(y * jnp.log(theta))
    )


def _multigammaln(a, K):
    j = jnp.arange(1, K + 1)
    return K * (K - 1) / 4.0 * math.log(math.pi) + jnp.sum(
        jax.lax.lgamma(a + (1.0 - j) / 2.0)
    )


def _lpdf_wishart(W, nu, S):
    K = S.shape[-1]
    _, logdet_w = jnp.linalg.slogdet(W)
    _, logdet_s = jnp.linalg.slogdet(S)
    tr = jnp.trace(jnp.linalg.solve(S, W))
    return (
        0.5 * (nu - K - 1.0) * logdet_w
        - 0.5 * tr
        - 0.5 * nu * K * math.log(2.0)
        - 0.5 * nu * logdet_s
        - _multigammaln(nu / 2.0, K)
    )


def _lpdf_inv_wishart(W, nu, S):
    K = S.shape[-1]
    _, logdet_w = jnp.linalg.slogdet(W)
    _, logdet_s = jnp.linalg.slogdet(S)
    tr = jnp.trace(jnp.linalg.solve(W, S))
    return (
        0.5 * nu * logdet_s
        - 0.5 * (nu + K + 1.0) * logdet_w
        - 0.5 * tr
        - 0.5 * nu * K * math.log(2.0)
        - _multigammaln(nu / 2.0, K)
    )


_DENSITIES = {
    "normal": _lpdf_normal,
    "std_normal": lambda y: _lpdf_normal(y, 0.0, 1.0),
    "cauchy": _lpdf_cauchy,
    "beta": _lpdf_beta,
    "bernoulli": _lpmf_bernoulli,
    "bernoulli_logit": lambda y, a: y * jax.nn.log_sigmoid(a)
    + (1.0 - y) * jax.nn.log_sigmoid(-a),
    "binomial": _lpmf_binomial,
    "uniform": _lpdf_uniform,
    "exponential": _lpdf_exponential,
    "lognormal": _lpdf_lognormal,
    "student_t": _lpdf_student_t,
    "gamma": _lpdf_gamma,
    "inv_gamma": _lpdf_inv_gamma,
    "poisson": _lpmf_poisson,
    "double_exponential": _lpdf_double_exponential,
    "logistic": _lpdf_logistic,
    "chi_square": _lpdf_chi_square,
    "weibull": _lpdf_weibull,
    "pareto": _lpdf_pareto,
    "neg_binomial_2": _lpmf_neg_binomial_2,
    "neg_binomial_2_log": _lpmf_neg_binomial_2_log,
    "poisson_log": _lpmf_poisson_log,
    "binomial_logit": _lpmf_binomial_logit,
    "von_mises": _lpdf_von_mises,
}

# log-CDFs for truncation (`y ~ dist(...) T[a, b]`) and the `_lcdf`/`_lccdf`
# call forms (Stan functions reference; used by the reference through
# BridgeStan). Each returns the elementwise log CDF.
def _lcdf_normal(y, mu, sigma):
    return jax.scipy.stats.norm.logcdf(y, mu, sigma)


def _lcdf_exponential(y, rate):
    return jnp.log(-jnp.expm1(-rate * y))


def _lcdf_uniform(y, a, b):
    return jnp.log(jnp.clip((y - a) / (b - a), 1e-38, 1.0))


def _lcdf_cauchy(y, mu, sigma):
    return jnp.log(0.5 + jnp.arctan((y - mu) / sigma) / math.pi)


def _lcdf_logistic(y, mu, sigma):
    return jax.nn.log_sigmoid((y - mu) / sigma)


def _lcdf_lognormal(y, mu, sigma):
    return jax.scipy.stats.norm.logcdf(jnp.log(y), mu, sigma)


def _lcdf_gamma(y, alpha, beta):
    return jnp.log(jax.scipy.special.gammainc(1.0 * alpha, beta * y))


def _lcdf_chi_square(y, nu):
    return jnp.log(jax.scipy.special.gammainc(0.5 * nu, 0.5 * y))


def _lcdf_weibull(y, alpha, sigma):
    return jnp.log(-jnp.expm1(-((y / sigma) ** alpha)))


def _lcdf_beta(y, a, b):
    return jnp.log(jax.scipy.special.betainc(1.0 * a, 1.0 * b, y))


def _lcdf_student_t(y, nu, mu, sigma):
    # via the regularized incomplete beta (Abramowitz & Stegun 26.7.1)
    z = (y - mu) / sigma
    x = nu / (nu + z * z)
    tail = 0.5 * jax.scipy.special.betainc(0.5 * nu, 0.5, x)
    return jnp.log(jnp.where(z > 0, 1.0 - tail, tail))


def _lcdf_double_exponential(y, mu, sigma):
    z = (y - mu) / sigma
    return jnp.where(
        z < 0, math.log(0.5) + z, jnp.log1p(-0.5 * jnp.exp(-z))
    )


def _lcdf_pareto(y, y_min, alpha):
    return jnp.log1p(-((y_min / y) ** alpha))


_LCDFS = {
    "normal": _lcdf_normal,
    "std_normal": lambda y: _lcdf_normal(y, 0.0, 1.0),
    "exponential": _lcdf_exponential,
    "uniform": _lcdf_uniform,
    "cauchy": _lcdf_cauchy,
    "logistic": _lcdf_logistic,
    "lognormal": _lcdf_lognormal,
    "gamma": _lcdf_gamma,
    "chi_square": _lcdf_chi_square,
    "weibull": _lcdf_weibull,
    "beta": _lcdf_beta,
    "student_t": _lcdf_student_t,
    "double_exponential": _lcdf_double_exponential,
    "pareto": _lcdf_pareto,
}


def _truncation_term(dist, y, args, lo, hi):
    """log of the truncation normalizer P(lo <= Y <= hi) (per element,
    broadcast over vectorized y), plus the support indicator: Stan's
    ``T[a, b]`` subtracts log(F(b) - F(a)) and rejects draws outside."""
    if dist not in _LCDFS:
        raise SyntaxError(
            f"stan: truncation T[,] is not supported for {dist!r} "
            f"(no log-CDF; supported: {sorted(_LCDFS)})"
        )
    cdf = _LCDFS[dist]
    if lo is not None and hi is not None:
        lz = jnp.log(
            jnp.clip(jnp.exp(cdf(hi, *args)) - jnp.exp(cdf(lo, *args)),
                     1e-38, 1.0)
        )
        inside = (y >= lo) & (y <= hi)
    elif lo is not None:
        lz = jnp.log1p(-jnp.exp(cdf(lo, *args)))
        inside = y >= lo
    elif hi is not None:
        lz = cdf(hi, *args)
        inside = y <= hi
    else:
        return jnp.zeros(())
    return jnp.sum(
        jnp.where(inside, jnp.broadcast_to(lz, jnp.shape(inside)), jnp.inf)
    )


# multivariate/container densities: the whole statement contributes ONE
# scalar (no elementwise summation over y's last axis)
_MV_DENSITIES = {
    "multi_normal": _lpdf_multi_normal,
    "multi_normal_cholesky": _lpdf_multi_normal_cholesky,
    "multi_normal_prec": _lpdf_multi_normal_prec,
    "dirichlet": _lpdf_dirichlet,
    "lkj_corr_cholesky": _lpdf_lkj_corr_cholesky,
    "lkj_corr": _lpdf_lkj_corr,
    "categorical": _lpmf_categorical,
    "categorical_logit": _lpmf_categorical_logit,
    "multinomial": _lpmf_multinomial,
    "ordered_logistic": _lpmf_ordered_logistic,
    "ordered_probit": _lpmf_ordered_probit,
    "wishart": _lpdf_wishart,
    "inv_wishart": _lpdf_inv_wishart,
}


def _as_f(v):
    if isinstance(v, (int, bool)):
        return float(v)
    return v


_MATH_FNS = {
    "exp": jnp.exp,
    "log": jnp.log,
    "expm1": jnp.expm1,
    "log1p": jnp.log1p,
    "log1m": lambda x: jnp.log1p(-x),
    "sqrt": jnp.sqrt,
    "square": lambda x: x * x,
    "inv": lambda x: 1.0 / _as_f(x),
    "inv_logit": jax.nn.sigmoid,
    "logit": lambda p: jnp.log(p) - jnp.log1p(-p),
    "pow": jnp.power,
    "abs": jnp.abs,
    "fabs": jnp.abs,
    "fmin": jnp.minimum,
    "fmax": jnp.maximum,
    "sum": jnp.sum,
    "mean": jnp.mean,
    "dot_self": lambda x: jnp.sum(x * x),
    "log1p_exp": jax.nn.softplus,
    "log_sum_exp": lambda *a: jnp.logaddexp(*a) if len(a) == 2 else jax.nn.logsumexp(jnp.stack(a)),
    "machine_precision": lambda: float(np.finfo(np.float64).eps),
    "lgamma": lambda x: jax.lax.lgamma(1.0 * x),
    "tgamma": lambda x: jnp.exp(jax.lax.lgamma(1.0 * x)),
    "num_elements": lambda x: int(np.prod(np.shape(x))) if np.shape(x) else 1,
    "rows": lambda x: int(np.shape(x)[0]),
    "cols": lambda x: int(np.shape(x)[1]),
    "size": lambda x: int(np.shape(x)[0]),
    "rep_vector": lambda v, n: jnp.full((int(n),), v),
    "rep_row_vector": lambda v, n: jnp.full((int(n),), v),
    "rep_array": lambda v, *ns: jnp.full(tuple(int(n) for n in ns), v),
    # -- matrix / linear algebra builtins (Stan functions reference ch. 5-7;
    # the reference reaches these through BridgeStan's C++, interface.jl:120) --
    "rep_matrix": lambda v, *ns: (
        jnp.full((int(ns[0]), int(ns[1])), v)
        if len(ns) == 2
        else (
            jnp.tile(jnp.asarray(v)[:, None], (1, int(ns[0])))
            if getattr(v, "ndim", 0) == 1
            else jnp.tile(jnp.asarray(v), (int(ns[0]), 1))
        )
    ),
    "diag_matrix": lambda v: jnp.diag(jnp.asarray(v)),
    "diagonal": lambda m: jnp.diagonal(m),
    "identity_matrix": lambda n: jnp.eye(int(n)),
    "cholesky_decompose": jnp.linalg.cholesky,
    "inverse": jnp.linalg.inv,
    "inverse_spd": jnp.linalg.inv,
    "determinant": lambda m: jnp.linalg.det(m),
    "log_determinant": lambda m: jnp.linalg.slogdet(m)[1],
    "trace": jnp.trace,
    "transpose": lambda m: jnp.transpose(m),
    "quad_form": lambda A, B: (
        jnp.asarray(B).T @ jnp.asarray(A) @ jnp.asarray(B)
    ),
    "quad_form_diag": lambda A, v: jnp.asarray(A)
    * (jnp.asarray(v)[:, None] * jnp.asarray(v)[None, :]),
    "quad_form_sym": lambda A, B: (
        jnp.asarray(B).T @ jnp.asarray(A) @ jnp.asarray(B)
    ),
    "diag_pre_multiply": lambda v, m: jnp.asarray(v)[:, None] * jnp.asarray(m),
    "diag_post_multiply": lambda m, v: jnp.asarray(m) * jnp.asarray(v)[None, :],
    "multiply_lower_tri_self_transpose": lambda L: (
        jnp.tril(L) @ jnp.tril(L).T
    ),
    "crossprod": lambda m: jnp.asarray(m).T @ jnp.asarray(m),
    "tcrossprod": lambda m: jnp.asarray(m) @ jnp.asarray(m).T,
    "mdivide_left_tri_low": lambda L, b: jax.scipy.linalg.solve_triangular(
        jnp.tril(L), jnp.asarray(b), lower=True
    ),
    "mdivide_right_tri_low": lambda b, L: jax.scipy.linalg.solve_triangular(
        jnp.tril(L).T, jnp.asarray(b).T, lower=False
    ).T,
    "mdivide_left": lambda A, b: jnp.linalg.solve(A, jnp.asarray(b)),
    "mdivide_right": lambda b, A: jnp.linalg.solve(
        jnp.asarray(A).T, jnp.asarray(b).T
    ).T,
    "dot_product": lambda a, b: jnp.dot(jnp.ravel(a), jnp.ravel(b)),
    "rows_dot_product": lambda a, b: jnp.sum(
        jnp.asarray(a) * jnp.asarray(b), axis=-1
    ),
    "columns_dot_product": lambda a, b: jnp.sum(
        jnp.asarray(a) * jnp.asarray(b), axis=0
    ),
    "rows_dot_self": lambda a: jnp.sum(jnp.square(jnp.asarray(a)), axis=-1),
    "columns_dot_self": lambda a: jnp.sum(jnp.square(jnp.asarray(a)), axis=0),
    "to_vector": lambda m: jnp.ravel(jnp.asarray(m), order="F")
    if getattr(m, "ndim", 0) == 2
    else jnp.ravel(jnp.asarray(m)),
    "to_row_vector": lambda m: jnp.ravel(jnp.asarray(m)),
    "to_array_1d": lambda m: jnp.ravel(jnp.asarray(m)),
    "to_matrix": lambda v, *ns: (
        jnp.reshape(jnp.asarray(v), (int(ns[0]), int(ns[1])), order="F")
        if len(ns) == 2
        else jnp.asarray(v)
    ),
    "col": lambda m, j: jnp.asarray(m)[:, int(j) - 1]
    if isinstance(j, (int, np.integer))
    else jnp.asarray(m)[:, jnp.asarray(j, jnp.int32) - 1],
    "row": lambda m, i: jnp.asarray(m)[int(i) - 1]
    if isinstance(i, (int, np.integer))
    else jnp.asarray(m)[jnp.asarray(i, jnp.int32) - 1],
    "head": lambda v, n: jnp.asarray(v)[: int(n)],
    "tail": lambda v, n: jnp.asarray(v)[-int(n):],
    "segment": lambda v, i, n: jax.lax.dynamic_slice_in_dim(
        jnp.asarray(v), jnp.asarray(i, jnp.int32) - 1, int(n)
    ),
    "append_row": lambda a, b: jnp.concatenate(
        [jnp.atleast_1d(jnp.asarray(a, jnp.result_type(a, b, float))),
         jnp.atleast_1d(jnp.asarray(b, jnp.result_type(a, b, float)))],
        axis=0,
    ),
    "append_col": lambda a, b: jnp.concatenate(
        [jnp.asarray(a), jnp.asarray(b)], axis=-1
    ),
    "softmax": jax.nn.softmax,
    "log_softmax": jax.nn.log_softmax,
    "cumulative_sum": jnp.cumsum,
    "reverse": lambda v: jnp.flip(jnp.asarray(v), axis=0),
    "sort_asc": lambda v: jnp.sort(jnp.asarray(v)),
    "sort_desc": lambda v: -jnp.sort(-jnp.asarray(v)),
    "sd": lambda v: jnp.std(jnp.asarray(v), ddof=1),
    "variance": lambda v: jnp.var(jnp.asarray(v), ddof=1),
    "prod": jnp.prod,
    "distance": lambda a, b: jnp.sqrt(
        jnp.sum(jnp.square(jnp.asarray(a) - jnp.asarray(b)))
    ),
    "squared_distance": lambda a, b: jnp.sum(
        jnp.square(jnp.asarray(a) - jnp.asarray(b))
    ),
    "norm2": lambda v: jnp.sqrt(jnp.sum(jnp.square(jnp.asarray(v)))),
    "norm1": lambda v: jnp.sum(jnp.abs(jnp.asarray(v))),
    # Stan overloads min/max: binary scalar form AND container reduction
    "min": lambda *a: jnp.min(a[0]) if len(a) == 1 else jnp.minimum(*a),
    "max": lambda *a: jnp.max(a[0]) if len(a) == 1 else jnp.maximum(*a),
    "floor": jnp.floor,
    "ceil": jnp.ceil,
    "sin": jnp.sin,
    "cos": jnp.cos,
    "tan": jnp.tan,
    "atan": jnp.arctan,
    "exp2": jnp.exp2,
    "log2": jnp.log2,
    "log10": jnp.log10,
    # -- additional scalar/special functions common in applied Stan --------
    "asin": jnp.arcsin,
    "acos": jnp.arccos,
    "sinh": jnp.sinh,
    "cosh": jnp.cosh,
    "tanh": jnp.tanh,
    "asinh": jnp.arcsinh,
    "acosh": jnp.arccosh,
    "atanh": jnp.arctanh,
    "atan2": jnp.arctan2,
    "hypot": jnp.hypot,
    "cbrt": jnp.cbrt,
    "round": jnp.round,
    "trunc": jnp.trunc,
    "fdim": lambda a, b: jnp.maximum(a - b, 0.0),
    "fmod": lambda a, b: jnp.fmod(a, b),
    "erf": jax.scipy.special.erf,
    "erfc": jax.scipy.special.erfc,
    "Phi": jax.scipy.stats.norm.cdf,
    "Phi_approx": lambda x: jax.nn.sigmoid(0.07056 * x**3 + 1.5976 * x),
    "inv_Phi": jax.scipy.stats.norm.ppf,
    "std_normal_lcdf": jax.scipy.stats.norm.logcdf,
    "digamma": jax.scipy.special.digamma,
    "trigamma": lambda x: jax.scipy.special.polygamma(1, x),
    "log_inv_logit": jax.nn.log_sigmoid,
    "log1m_inv_logit": lambda x: jax.nn.log_sigmoid(-x),
    "inv_cloglog": lambda x: -jnp.expm1(-jnp.exp(x)),
    "cloglog": lambda p: jnp.log(-jnp.log1p(-p)),
    "log1m_exp": lambda x: jnp.log(-jnp.expm1(x)),  # x < 0
    "log_diff_exp": lambda a, b: a + jnp.log(-jnp.expm1(b - a)),
    "lmultiply": lambda a, b: jnp.where(a == 0, 0.0, a * jnp.log(b)),
    "lchoose": lambda n, k: (
        jax.lax.lgamma(1.0 + n)
        - jax.lax.lgamma(1.0 + k)
        - jax.lax.lgamma(1.0 + n - k)
    ),
    "lbeta": lambda a, b: (
        jax.lax.lgamma(1.0 * a)
        + jax.lax.lgamma(1.0 * b)
        - jax.lax.lgamma(1.0 * (a + b))
    ),
    "log_mix": lambda theta, la, lb: jnp.logaddexp(
        jnp.log(theta) + la, jnp.log1p(-theta) + lb
    ),
    "logistic_sigmoid": jax.nn.sigmoid,
    "step": lambda x: jnp.where(x >= 0, 1.0, 0.0),
    "int_step": lambda x: jnp.where(x > 0, 1, 0),
    "positive_infinity": lambda: jnp.inf,
    "negative_infinity": lambda: -jnp.inf,
    "not_a_number": lambda: jnp.nan,
    "is_nan": lambda x: jnp.isnan(x),
    "is_inf": lambda x: jnp.isinf(x),
}


# ---------------------------------------------------------------------------
# evaluator
# ---------------------------------------------------------------------------


class _Return(Exception):
    """Raised for a top-level (unconditional) return."""

    def __init__(self, value):
        self.value = value


class _Break(Exception):
    """Raised for `break` under concrete (data-computable) control flow."""


class _Continue(Exception):
    """Raised for `continue` under concrete control flow."""


def _stan_mul(a, b, node_a, node_b):
    """Stan `*`: matrix algebra, not elementwise (`.*` is elementwise).

    Containers collapse to jnp arrays without a row/column tag, so two 1-D
    operands are disambiguated syntactically: ``v * u'`` is an outer product,
    anything else (``x' * y``, ``row_vector * vector``) a dot product —
    Stan's type system only admits row*col and col*row for 1-D pairs."""
    an, bn = getattr(a, "ndim", 0), getattr(b, "ndim", 0)
    if an == 0 or bn == 0:
        return a * b
    if an == 2 or bn == 2:
        return jnp.matmul(a, b)
    if isinstance(node_b, tuple) and node_b[0] == "transpose":
        if not (isinstance(node_a, tuple) and node_a[0] == "transpose"):
            return jnp.outer(a, b)  # v * u'
    return jnp.dot(a, b)


def _mv_density_sum(dist, y, params):
    """Container densities contribute one scalar per statement (no implicit
    elementwise vectorization beyond what the density itself defines)."""
    return _MV_DENSITIES[dist](y, *params)


class _Evaluator:
    """Tree-walking evaluator building jnp expressions during tracing.

    ``if``/early-``return`` with traced conditions compile to ``where``
    blends: statements execute both branches on copies of the environment
    and blend every modified variable; conditional returns accumulate as
    (condition, value) pairs resolved when the function exits. Conditions
    that are concrete Python values short-circuit to real branches."""

    def __init__(self, functions, rng=None):
        self.functions = {f[0]: f for f in functions}
        self.rng = rng  # np.random.Generator for *_rng (host extraction only)

    # -- expressions -----------------------------------------------------

    def eval_expr(self, node, env):
        kind = node[0]
        if kind == "num":
            return node[1]
        if kind == "var":
            if node[1] not in env:
                raise NameError(f"stan: undefined variable {node[1]!r}")
            return env[node[1]]
        if kind == "bin":
            op, a, b = node[1], self.eval_expr(node[2], env), self.eval_expr(node[3], env)
            if op == "+":
                return a + b
            if op == "-":
                return a - b
            if op == "*":
                return _stan_mul(a, b, node[2], node[3])
            if op == "/":
                if isinstance(a, (int, np.integer)) and isinstance(b, (int, np.integer)):
                    # Stan int division truncates toward zero (C semantics),
                    # unlike Python's floor division: -3/2 == -1
                    q = abs(int(a)) // abs(int(b))
                    return -q if (a < 0) != (b < 0) else q
                if getattr(a, "ndim", 0) == 2 and getattr(b, "ndim", 0) == 2:
                    # matrix division A / B = A B^-1 (mdivide_right)
                    return jnp.linalg.solve(jnp.asarray(b).T, jnp.asarray(a).T).T
                return a / b
            if op == "\\":
                # left division A \ b = A^-1 b (mdivide_left)
                return jnp.linalg.solve(jnp.asarray(a), jnp.asarray(b))
            if op == "^":
                return _as_f(a) ** b
            if op == "%":
                if isinstance(a, (int, np.integer)) and isinstance(b, (int, np.integer)):
                    # C semantics: result carries the sign of the dividend
                    return int(math.fmod(int(a), int(b)))
                return a % b
            if op == ".*":
                return a * b
            if op == "./":
                return a / b
        if kind == "unary":
            v = self.eval_expr(node[2], env)
            if node[1] == "-":
                return -v
            if node[1] == "!":
                return jnp.logical_not(v) if hasattr(v, "dtype") else (not v)
            return v
        if kind == "cmp":
            op, a, b = node[1], self.eval_expr(node[2], env), self.eval_expr(node[3], env)
            return {
                "<": lambda: a < b,
                "<=": lambda: a <= b,
                ">": lambda: a > b,
                ">=": lambda: a >= b,
                "==": lambda: a == b,
                "!=": lambda: a != b,
            }[op]()
        if kind == "and":
            a = self.eval_expr(node[1], env)
            b = self.eval_expr(node[2], env)
            return jnp.logical_and(a, b) if _traced(a) or _traced(b) else (a and b)
        if kind == "or":
            a = self.eval_expr(node[1], env)
            b = self.eval_expr(node[2], env)
            return jnp.logical_or(a, b) if _traced(a) or _traced(b) else (a or b)
        if kind == "ternary":
            c = self.eval_expr(node[1], env)
            if isinstance(c, (bool, np.bool_)):
                return self.eval_expr(node[2] if c else node[3], env)
            # traced condition: both branches are traced (Stan's C++ only
            # executes one), so sanitize inputs on untaken lanes — the
            # double-where trick — or inf/NaN in the dead branch would
            # poison gradients (e.g. mRNA's exp_a_minus_exp_b at overflow)
            a = self.eval_expr(node[2], _mask_env(env, c))
            b = self.eval_expr(node[3], _mask_env(env, jnp.logical_not(c)))
            return jnp.where(c, a, b)
        if kind == "index":
            base = self.eval_expr(node[1], env)
            idx = tuple(self._eval_index_item(i, env) for i in node[2])
            return base[idx if len(idx) > 1 else idx[0]]
        if kind == "transpose":
            v = self.eval_expr(node[1], env)
            return jnp.transpose(v) if hasattr(v, "ndim") and v.ndim > 1 else v
        if kind == "call":
            return self.eval_call(node[1], node[2], env)
        raise SyntaxError(f"stan: cannot evaluate {node!r}")

    def _eval_index_item(self, node, env):
        """One multi-index item -> a 0-based int/array index or a slice.
        Range bounds must be data (concrete) — Stan slices are shape-level."""
        if isinstance(node, tuple) and node[0] == "irange":
            lo = None if node[1] is None else self.eval_expr(node[1], env)
            hi = None if node[2] is None else self.eval_expr(node[2], env)
            for v in (lo, hi):
                if v is not None and not isinstance(v, (int, np.integer)):
                    raise SyntaxError(
                        "stan: range-index bounds must be data (concrete at "
                        "trace time)"
                    )
            return slice(None if lo is None else int(lo) - 1,
                         None if hi is None else int(hi))
        i = self.eval_expr(node, env)
        return i - 1  # Stan is 1-indexed

    def eval_call(self, name, arg_nodes, env):
        args = [self.eval_expr(a, env) for a in arg_nodes]
        if name in self.functions:
            return self.call_function(name, args)
        if name in _MATH_FNS:
            return _MATH_FNS[name](*args)
        if name.endswith("_lpdf") or name.endswith("_lpmf"):
            dist = name[:-5]
            if dist in _MV_DENSITIES:
                return _mv_density_sum(dist, args[0], args[1:])
            if dist not in _DENSITIES:
                raise SyntaxError(f"stan: unsupported density {dist!r}")
            return jnp.sum(_DENSITIES[dist](args[0], *args[1:]))
        if name.endswith("_lcdf") or name.endswith("_lccdf"):
            dist = name[: -5 if name.endswith("_lcdf") else -6]
            if dist not in _LCDFS:
                raise SyntaxError(f"stan: no log-CDF for {dist!r}")
            lc = _LCDFS[dist](args[0], *args[1:])
            if name.endswith("_lccdf"):
                lc = jnp.log(-jnp.expm1(jnp.minimum(lc, -1e-38)))
            return jnp.sum(lc)
        if name.endswith("_rng"):
            dist = name[:-4]
            if self.rng is None:
                raise RuntimeError(
                    f"stan: {name} is only available in generated quantities "
                    "during host-side extraction"
                )
            return self._draw(dist, args)
        raise SyntaxError(f"stan: unknown function {name!r}")

    def _draw(self, dist, args):
        r = self.rng
        a = [np.asarray(x) for x in args]
        if dist == "normal":
            return r.normal(a[0], a[1])
        if dist == "bernoulli":
            return (r.random(np.shape(a[0])) < a[0]).astype(np.float64)
        if dist == "uniform":
            return r.uniform(a[0], a[1])
        if dist == "exponential":
            return r.exponential(1.0 / a[0])
        if dist == "beta":
            return r.beta(a[0], a[1])
        if dist == "binomial":
            return r.binomial(int(a[0]), a[1])
        if dist == "gamma":
            return r.gamma(a[0], 1.0 / a[1])
        if dist == "poisson":
            return r.poisson(a[0])
        if dist == "lognormal":
            return r.lognormal(a[0], a[1])
        if dist == "student_t":
            return a[1] + a[2] * r.standard_t(a[0])
        if dist == "cauchy":
            return a[0] + a[1] * np.tan(np.pi * (r.random() - 0.5))
        if dist == "dirichlet":
            return r.dirichlet(np.asarray(a[0], np.float64))
        if dist == "multi_normal":
            return r.multivariate_normal(a[0], a[1])
        if dist == "categorical":
            p = np.asarray(a[0], np.float64)
            return 1 + r.choice(len(p), p=p / p.sum())
        if dist == "multinomial":
            # Stan: multinomial_rng(theta, N)
            return r.multinomial(int(a[1]), np.asarray(a[0], np.float64))
        raise SyntaxError(f"stan: unsupported rng {dist!r}")

    def call_function(self, name, args):
        fname, ret_type, params, body = self.functions[name]
        env = {p[1]: a for p, a in zip(params, args)}
        try:
            rets = self.exec_stmts(body, env)
        except _Return as r:
            return r.value
        if not rets:
            return None
        # blend conditional returns (last unconditional return is the base)
        base = None
        conds = []
        for cond, val in rets:
            if cond is None:
                base = val
            else:
                conds.append((cond, val))
        out = base
        for cond, val in reversed(conds):
            out = val if out is None else jnp.where(cond, val, out)
        return out

    # -- statements ------------------------------------------------------

    def exec_stmts(self, stmts, env, mask=None):
        """Execute statements into ``env``; returns a list of
        (condition-or-None, value) for returns reached under traced
        conditions. ``mask`` is the traced path condition (None = on all
        lanes). After a conditional return, the remaining statements run
        under the narrowed mask with a re-sanitized environment, so code
        that is dead on the returned path cannot overflow into NaN
        gradients (e.g. mRNA's ``if (tmt0 <= 0) return 0;`` followed by
        ``exp(-beta*tmt0)``)."""
        rets = []
        cur_mask = mask
        for s in stmts:
            r = self.exec_stmt(s, env, cur_mask)
            rets.extend(r)
            for rc, _ in r:
                if rc is not None and _traced(rc):
                    alive = jnp.logical_not(rc)
                    if cur_mask is not None:
                        alive = jnp.logical_and(cur_mask, alive)
                    cur_mask = alive
                    san = _mask_env(env, cur_mask)
                    env.clear()
                    env.update(san)
        return rets

    def exec_stmt(self, s, env, mask):
        kind = s[0]
        if kind == "nop":
            return []
        if kind == "block":
            return self.exec_stmts(s[1], env, mask)
        if kind == "decl":
            _, name, base, adims, edims, lower, upper, init = s
            if init is not None:
                env[name] = self.eval_expr(init, env)
            else:
                shape = tuple(
                    int(self.eval_expr(d, env)) for d in adims + edims
                )
                if base in _SPECIAL_MAT and len(edims) == 1:
                    shape = shape + (shape[-1],)  # square container
                env[name] = jnp.zeros(shape) if shape else 0.0
            return []
        if kind == "assign":
            lv, op, rhs = s[1], s[2], s[3]
            val = self.eval_expr(rhs, env)
            return self._assign(lv, op, val, env, mask)
        if kind == "reject":
            # Stan semantics: the proposal is rejected -> density -inf on
            # the lanes that reach the statement (NaN-guarded to -inf by the
            # runtime either way)
            inc = jnp.float32(-jnp.inf)
            if mask is not None:
                inc = jnp.where(mask, inc, 0.0)
            env["__target__"] = env.get("__target__", 0.0) + inc
            return []
        if kind == "target":
            inc = self.eval_expr(s[1], env)
            inc = jnp.sum(inc) if hasattr(inc, "ndim") and getattr(inc, "ndim", 0) else inc
            if mask is not None:
                inc = jnp.where(mask, inc, 0.0)
            env["__target__"] = env.get("__target__", 0.0) + inc
            return []
        if kind == "sample":
            y = self.eval_expr(s[1], env)
            dist = s[2]
            if dist.endswith("_lpdf") or dist.endswith("_lpmf"):
                dist = dist[:-5]
            args = [self.eval_expr(a, env) for a in s[3]]
            trunc = s[4] if len(s) > 4 else None
            if dist in _MV_DENSITIES:
                if trunc is not None:
                    raise SyntaxError(
                        f"stan: truncation is not defined for {dist!r}"
                    )
                inc = _mv_density_sum(dist, y, args)
            elif dist in _DENSITIES:
                inc = jnp.sum(_DENSITIES[dist](y, *args))
                if trunc is not None:
                    lo = None if trunc[0] is None else self.eval_expr(trunc[0], env)
                    hi = None if trunc[1] is None else self.eval_expr(trunc[1], env)
                    inc = inc - _truncation_term(dist, y, args, lo, hi)
            else:
                raise SyntaxError(f"stan: unsupported density {dist!r}")
            if mask is not None:
                inc = jnp.where(mask, inc, 0.0)
            env["__target__"] = env.get("__target__", 0.0) + inc
            return []
        if kind == "for":
            lo = self.eval_expr(s[2], env)
            hi = self.eval_expr(s[3], env)
            if not isinstance(lo, (int, np.integer)) or not isinstance(hi, (int, np.integer)):
                raise SyntaxError(
                    "stan: loop bounds must be data (loops unroll at trace time)"
                )
            vec = self._vectorized_for(s, int(lo), int(hi), env, mask)
            if vec is not None:
                return vec
            rets = []
            for i in range(int(lo), int(hi) + 1):
                env[s[1]] = i
                try:
                    rets.extend(self.exec_stmts(s[4], env, mask))
                except _Continue:
                    continue
                except _Break:
                    break
            env.pop(s[1], None)
            return rets
        if kind == "while":
            # condition must be data-computable: the loop runs at trace time
            # (like `for`); traced conditions fail loudly rather than
            # silently tracing forever
            rets = []
            n_iter = 0
            while True:
                cond = self.eval_expr(s[1], env)
                if _traced(cond):
                    raise SyntaxError(
                        "stan: while conditions must be data-computable "
                        "(concrete at trace time); parameter-dependent "
                        "while loops cannot compile to a static XLA graph"
                    )
                if not bool(cond):
                    break
                n_iter += 1
                if n_iter > 1_000_000:
                    raise RuntimeError(
                        "stan: while loop exceeded 1e6 trace-time iterations"
                    )
                try:
                    rets.extend(self.exec_stmts(s[2], env, mask))
                except _Continue:
                    continue
                except _Break:
                    break
            return rets
        if kind == "break":
            if mask is not None:
                raise SyntaxError(
                    "stan: break under a parameter-dependent condition is "
                    "not supported (control flow must be data-computable)"
                )
            raise _Break()
        if kind == "continue":
            if mask is not None:
                raise SyntaxError(
                    "stan: continue under a parameter-dependent condition "
                    "is not supported (control flow must be data-computable)"
                )
            raise _Continue()
        if kind == "if":
            cond = self.eval_expr(s[1], env)
            if isinstance(cond, (bool, np.bool_)):
                return self.exec_stmts(s[2] if cond else s[3], env, mask)
            # traced condition: run both branches on SANITIZED copies of the
            # environment (untaken lanes see dummy inputs — the double-where
            # trick, so dead-branch inf/NaN cannot poison values or
            # gradients), then blend every write
            c = cond if mask is None else jnp.logical_and(mask, cond)
            notc = jnp.logical_not(cond) if mask is None else jnp.logical_and(
                mask, jnp.logical_not(cond)
            )
            env_t = _mask_env(env, cond)
            base_t = dict(env_t)
            rets = [
                (jnp.logical_and(c, rc) if rc is not None else c, rv)
                for rc, rv in self.exec_stmts(s[2], env_t, c)
            ]
            env_f = _mask_env(env, jnp.logical_not(cond))
            base_f = dict(env_f)
            rets += [
                (jnp.logical_and(notc, rc) if rc is not None else notc, rv)
                for rc, rv in self.exec_stmts(s[3], env_f, notc)
            ]
            for k in set(env_t) | set(env_f):
                mod_t = env_t.get(k) is not base_t.get(k)
                mod_f = env_f.get(k) is not base_f.get(k)
                if not (mod_t or mod_f):
                    continue  # untouched: keep the original, unsanitized value
                vt = env_t[k] if mod_t else env.get(k)
                vf = env_f[k] if mod_f else env.get(k)
                if vt is None:  # declared only inside the then-branch
                    env[k] = env_t[k]
                elif vf is None:
                    env[k] = env_f[k]
                else:
                    env[k] = jnp.where(cond, vt, vf)
            return rets
        if kind == "return":
            val = None if s[1] is None else self.eval_expr(s[1], env)
            if mask is None:
                raise _Return(val)
            return [(mask, val)]
        raise SyntaxError(f"stan: cannot execute {s!r}")

    def _vectorized_for(self, s, lo, hi, env, mask):
        """Vectorize a data-length loop of pure sampling statements.

        ``for (i in 1:N) y[i] ~ normal(mu[i], sigma);`` unrolled costs O(N)
        trace time; with the loop variable bound to ``arange(lo, hi+1)`` the
        body evaluates ONCE with vector semantics (1-based gathers become
        batched gathers) and the elementwise density sums to exactly the same
        total. Only applied when every body statement is a univariate
        ``~``-statement and every evaluated operand is a scalar or an
        [N]-vector — anything else (assignments, matrix-shaped operands,
        nested loops, container densities) falls back to unrolling, keeping
        semantics identical. This is the compile-time-scaling guard: the
        reference compiles Stan once through BridgeStan independent of data
        size (ext/PigeonsBridgeStanExt/interface.jl); here the trace of a
        10^5-row likelihood loop stays O(1) in the data length."""
        n = hi - lo + 1
        if n < 32:
            return None  # unroll small loops (keeps traces bit-stable)
        body = s[4]
        if not body or any(
            st[0] != "sample" or (len(st) > 4 and st[4] is not None)
            for st in body
        ):
            return None  # assignments / truncated statements: unroll
        venv = dict(env)
        # HOST-numpy index vector: under a jit trace a jnp.arange would be a
        # (constant-valued) tracer, and numpy data arrays cannot be fancy-
        # indexed by tracers — np keeps data gathers concrete either way
        venv[s[1]] = np.arange(lo, hi + 1)
        total = jnp.zeros(())
        try:
            for st in body:
                y = self.eval_expr(st[1], venv)
                dist = st[2]
                if dist.endswith("_lpdf") or dist.endswith("_lpmf"):
                    dist = dist[:-5]
                if dist not in _DENSITIES:
                    return None
                args = [self.eval_expr(a, venv) for a in st[3]]
                if not all(np.shape(v) in ((), (n,)) for v in (y, *args)):
                    return None
                total = total + jnp.sum(_DENSITIES[dist](y, *args))
        except Exception:
            return None  # the unrolled path re-raises any real model error
        if mask is not None:
            total = jnp.where(mask, total, 0.0)
        env["__target__"] = env.get("__target__", 0.0) + total
        return []

    def _assign(self, lv, op, val, env, mask):
        if lv[0] == "var":
            name = lv[1]
            cur = env.get(name, 0.0)
            new = val if op == "=" else _apply_aug(op, cur, val)
            if mask is not None and op != "=" or (mask is not None and name in env):
                new = jnp.where(mask, new, cur)
            env[name] = new
            return []
        if lv[0] == "index":
            base_name = lv[1]
            if base_name[0] != "var":
                raise SyntaxError("stan: only simple indexed assignment supported")
            name = base_name[1]
            idx = tuple(self.eval_expr(i, env) - 1 for i in lv[2])
            arr = jnp.asarray(env[name])
            sel = idx if len(idx) > 1 else idx[0]
            cur = arr[sel]
            new = val if op == "=" else _apply_aug(op, cur, val)
            if mask is not None:
                new = jnp.where(mask, new, cur)
            env[name] = arr.at[sel].set(new)
            return []
        raise SyntaxError(f"stan: unsupported lvalue {lv!r}")


def _apply_aug(op, cur, val):
    return {
        "+=": lambda: cur + val,
        "-=": lambda: cur - val,
        "*=": lambda: cur * val,
        "/=": lambda: cur / val,
    }[op]()


def _traced(v):
    return isinstance(v, jax.core.Tracer) or isinstance(v, jax.Array)


def _mask_env(env, cond):
    """Branch-entry input sanitization (the generalized double-``where``
    trick): on lanes where ``cond`` is False, every traced floating value is
    replaced by 1.0 before the branch body is traced. The branch's outputs on
    those lanes are discarded by the caller's blend, and the cotangent chain
    through the ``where`` is zero — so overflow/0-division in the dead branch
    can no longer produce NaN values OR NaN gradients (Stan's C++ gets this
    for free by executing only one branch). Only scalar conditions sanitize
    (the subset's conditions are scalars; anything else passes through)."""
    if getattr(cond, "shape", ()) != ():
        return dict(env)
    out = {}
    for k, v in env.items():
        if (
            k != "__target__"
            and _traced(v)
            and jnp.issubdtype(jnp.result_type(v), jnp.floating)
        ):
            out[k] = jnp.where(cond, v, jnp.ones_like(v))
        else:
            out[k] = v
    return out


# ---------------------------------------------------------------------------
# constraint transforms (Stan reference manual ch. 10, change of variables).
# Closed-form log-jacobians; each is verified against the autodiff
# slogdet(jacobian) oracle in tests/test_stan_lang.py.
# ---------------------------------------------------------------------------


def _constrain_scalarwise(u, lower, upper):
    """Unconstrained -> constrained + log-jacobian, elementwise (Stan's
    lb/ub/lub transforms)."""
    if lower is None and upper is None:
        return u, jnp.zeros_like(u)
    if lower is not None and upper is None:
        return lower + jnp.exp(u), u
    if lower is None and upper is not None:
        return upper - jnp.exp(u), u
    width = upper - lower
    s = jax.nn.sigmoid(u)
    x = lower + width * s
    logjac = jnp.log(width) + jax.nn.log_sigmoid(u) + jax.nn.log_sigmoid(-u)
    return x, logjac


def _constrain_simplex(u):
    """Stick-breaking (Stan 10.6): u [K-1] -> x on the K-simplex."""
    K = u.shape[0] + 1
    ks = jnp.arange(1, K)
    z = jax.nn.sigmoid(u - jnp.log(1.0 * (K - ks)))

    def step(rem, zk):
        xk = zk * rem
        lj = jnp.log(zk) + jnp.log1p(-zk) + jnp.log(rem)
        return rem - xk, (xk, lj)

    rem, (xs, ljs) = jax.lax.scan(step, jnp.ones(()), z)
    x = jnp.concatenate([xs, rem[None]])
    return x, jnp.sum(ljs)


def _constrain_ordered(u):
    """x_1 = u_1, x_k = x_(k-1) + exp(u_k) (Stan 10.4)."""
    x = u[0] + jnp.concatenate(
        [jnp.zeros((1,)), jnp.cumsum(jnp.exp(u[1:]))]
    )
    return x, jnp.sum(u[1:])


def _constrain_positive_ordered(u):
    x = jnp.cumsum(jnp.exp(u))
    return x, jnp.sum(u)


def _constrain_unit_vector(u):
    """x = u/|u| with Stan's auxiliary -|u|^2/2 'jacobian' term (Stan 10.8:
    the pushforward of the standard normal is uniform on the sphere)."""
    r2 = jnp.sum(u * u)
    x = u / jnp.sqrt(r2)
    return x, -0.5 * r2


def _cpc_cholesky(u, K):
    """Canonical-partial-correlation -> Cholesky factor of a correlation
    matrix (Stan 10.12). ``u`` is the K(K-1)/2 strictly-lower entries in
    row-major order. Returns (L, logjac) where logjac covers both the tanh
    and the CPC->L maps: sum over strict-lower (i,j) of
    log(1-z_ij^2) + log prod_(j'<j) sqrt(1-z_ij'^2)."""
    il = np.tril_indices(K, -1)  # row-major strict lower
    z = jnp.zeros((K, K), u.dtype).at[il].set(jnp.tanh(u))
    mask_sl = np.tril(np.ones((K, K), bool), -1)
    c = jnp.where(mask_sl, jnp.sqrt(1.0 - z * z), 1.0)
    cp_inc = jnp.cumprod(c, axis=1)
    ecp = jnp.concatenate(
        [jnp.ones((K, 1), u.dtype), cp_inc[:, :-1]], axis=1
    )  # exclusive row cumprod: remaining length before column j
    L = jnp.where(mask_sl, z * ecp, 0.0) + jnp.diag(jnp.diagonal(ecp))
    logjac = jnp.sum(
        jnp.where(mask_sl, jnp.log1p(-z * z) + jnp.log(ecp), 0.0)
    )
    return L, logjac


def _constrain_cholesky_factor_corr(u, K):
    return _cpc_cholesky(u, K)


def _constrain_corr_matrix(u, K):
    L, logjac = _cpc_cholesky(u, K)
    R = L @ L.T
    # L -> R on the strict lower triangle is triangular with dR_ij/dL_ij =
    # L_jj: each column-j diagonal appears once per row below it
    diag = jnp.diagonal(L)
    w = jnp.arange(K - 1, -1, -1, dtype=u.dtype)  # K-1-j for 0-based j
    return R, logjac + jnp.sum(w * jnp.log(diag))


def _constrain_cov_matrix(u, K):
    """u = (log-diagonal [K], strict-lower row-major [K(K-1)/2]);
    Sigma = L L' with L_ii = exp(d_i). log|J| = K log 2 + sum (K-j+1) d_j
    (0-based j; Stan 10.9's K log 2 + sum (K-k+2) z_kk with 1-based k)."""
    d = u[:K]
    il = np.tril_indices(K, -1)
    L = jnp.zeros((K, K), u.dtype).at[il].set(u[K:]) + jnp.diag(jnp.exp(d))
    Sigma = L @ L.T
    w = jnp.arange(K + 1, 1, -1, dtype=u.dtype)  # K-j+1 for j=0..K-1
    return Sigma, K * math.log(2.0) + jnp.sum(w * d)


def _constrain_cholesky_factor_cov(u, M, N):
    """Lower-trapezoidal [M, N] factor with positive diagonal: diagonal logs
    first, then the below-diagonal entries row-major. log|J| = sum d."""
    d = u[:N]
    rest = u[N:]
    rows, cols = np.tril_indices(M, -1)
    keep = cols < N
    rows, cols = rows[keep], cols[keep]
    L = (
        jnp.zeros((M, N), u.dtype)
        .at[rows, cols].set(rest)
        .at[jnp.arange(N), jnp.arange(N)].set(jnp.exp(d))
    )
    return L, jnp.sum(d)


# ---------------------------------------------------------------------------
# parameter specs: one transform per declared parameter
# ---------------------------------------------------------------------------


class _ParamSpec:
    """One parameters-block declaration compiled to its unconstraining
    transform: ``constrain(u[unc_size]) -> (value[shape], logjac)``."""

    def __init__(self, name, off, unc_size, shape, constrain, kind, identity):
        self.name = name
        self.off = off
        self.unc_size = unc_size
        self.shape = shape  # constrained shape (incl. leading array dims)
        self.constrain = constrain
        self.kind = kind
        self.identity = identity  # True iff value == u (no transform)

    @property
    def size(self):
        return int(np.prod(self.shape)) if self.shape else 1


def _base_transform(kind, edims, lo, hi):
    """One element's transform: (unc_base_size, base_shape, fn)."""
    if kind in ("int", "real", "vector", "row_vector", "matrix"):
        shape = tuple(edims)
        size = int(np.prod(shape)) if shape else 1

        def fn(u):
            v, lj = _constrain_scalarwise(u, lo, hi)
            return (v.reshape(shape) if shape else v[0]), jnp.sum(lj)

        return size, shape, fn
    if kind == "simplex":
        K = edims[0]
        return K - 1, (K,), _constrain_simplex
    if kind == "ordered":
        K = edims[0]
        return K, (K,), _constrain_ordered
    if kind == "positive_ordered":
        K = edims[0]
        return K, (K,), _constrain_positive_ordered
    if kind == "unit_vector":
        K = edims[0]
        return K, (K,), _constrain_unit_vector
    if kind == "cholesky_factor_corr":
        K = edims[0]
        return K * (K - 1) // 2, (K, K), lambda u: _constrain_cholesky_factor_corr(u, K)
    if kind == "corr_matrix":
        K = edims[0]
        return K * (K - 1) // 2, (K, K), lambda u: _constrain_corr_matrix(u, K)
    if kind == "cov_matrix":
        K = edims[0]
        return K * (K + 1) // 2, (K, K), lambda u: _constrain_cov_matrix(u, K)
    if kind == "cholesky_factor_cov":
        M = edims[0]
        N = edims[1] if len(edims) > 1 else M
        n_below = sum(min(i, N) for i in range(M))
        return N + n_below, (M, N), lambda u: _constrain_cholesky_factor_cov(u, M, N)
    raise SyntaxError(f"stan: unsupported parameter type {kind!r}")


def _make_param_spec(name, off, kind, adims, edims, lo, hi):
    unc_base, base_shape, fn = _base_transform(kind, edims, lo, hi)
    identity = (
        kind in ("real", "vector", "row_vector", "matrix")
        and lo is None
        and hi is None
    )
    if not adims:
        return _ParamSpec(name, off, unc_base, base_shape, fn, kind, identity)
    A = int(np.prod(adims))

    def fn_arr(u):
        vals, ljs = jax.vmap(fn)(u.reshape(A, unc_base))
        return vals.reshape(tuple(adims) + base_shape), jnp.sum(ljs)

    return _ParamSpec(
        name, off, A * unc_base, tuple(adims) + base_shape, fn_arr, kind,
        identity,
    )


# ---------------------------------------------------------------------------
# the target
# ---------------------------------------------------------------------------


class StanTarget(Target):
    """A parsed ``.stan`` model as a pigeons_tpu target (reference:
    ``StanLogPotential`` + BridgeStan ext)."""

    def __init__(self, source: str, data: Optional[dict] = None, name: str = "stan_model"):
        self.source = source
        self.name = name
        blocks = _Parser(_tokenize(source)).parse_program()
        self._blocks = blocks
        self._ev = _Evaluator(blocks.get("functions", []))

        # data block: bind + validate
        data = dict(data or {})
        env = {}
        for d in blocks.get("data", []):
            _, dname, base, adims, edims, lower, upper, init = d
            if dname not in data:
                raise ValueError(f"stan: missing data value for {dname!r}")
            v = data[dname]
            if not adims and not edims:
                v = int(v) if base == "int" else float(v)
            else:
                dt = np.int64 if base == "int" else np.float64
                v = np.asarray(v, dtype=dt)
                want = tuple(
                    int(self._ev.eval_expr(dd, env)) for dd in adims + edims
                )
                if base in _SPECIAL_MAT and len(edims) == 1:
                    want = want + (want[-1],)
                if v.shape != want:
                    raise ValueError(
                        f"stan: data {dname!r} has shape {v.shape}, declared "
                        f"{want}"
                    )
            env[dname] = v
        # transformed data: runs once, host-side
        td_env = dict(env)
        self._ev.exec_stmts(blocks.get("transformed data", []), td_env)
        td_env.pop("__target__", None)
        self._data_env = td_env

        # parameters: one unconstraining transform per declaration
        self._params = []
        off = 0
        for p in blocks.get("parameters", []):
            _, pname, base, adims, edims, lower, upper, init = p
            if base == "int":
                raise ValueError(
                    "stan: integer parameters are not supported (Stan itself "
                    "forbids them)"
                )
            adims_c = tuple(int(self._ev.eval_expr(d, td_env)) for d in adims)
            edims_c = tuple(int(self._ev.eval_expr(d, td_env)) for d in edims)
            lo = None if lower is None else self._ev.eval_expr(lower, td_env)
            hi = None if upper is None else self._ev.eval_expr(upper, td_env)
            spec = _make_param_spec(pname, off, base, adims_c, edims_c, lo, hi)
            self._params.append(spec)
            off += spec.unc_size
        self.dim = off
        if off == 0:
            raise ValueError("stan: model has no parameters")

    # -- plumbing --------------------------------------------------------

    def _constrain_env(self, x):
        """x (unconstrained flat) -> (env incl. transformed parameters,
        total log-jacobian)."""
        env = dict(self._data_env)
        logjac = jnp.zeros(())
        for spec in self._params:
            u = x[spec.off : spec.off + spec.unc_size]
            v, lj = spec.constrain(u)
            logjac = logjac + lj
            env[spec.name] = v
        ev = _Evaluator(self._blocks.get("functions", []))
        ev.exec_stmts(self._blocks.get("transformed parameters", []), env)
        env.pop("__target__", None)
        return env, logjac

    def log_density(self, x):
        """BridgeStan convention: model block + constraint jacobian,
        propto=false (``interface.jl:64-69``)."""
        env, logjac = self._constrain_env(x)
        env["__target__"] = jnp.zeros(())
        ev = _Evaluator(self._blocks.get("functions", []))
        ev.exec_stmts(self._blocks.get("model", []), env)
        return env["__target__"] + logjac

    def default_reference(self) -> Reference:
        d = self.dim
        return Reference(
            log_density=lambda u: jnp.sum(-0.5 * u * u - _HALF_LOG_2PI),
            sample_iid=lambda key: jax.random.normal(key, (d,)),
        )

    def default_explorer(self):
        from ..ops import AutoMALA

        return AutoMALA()  # reference interface.jl:51

    # -- extraction (param_constrain with tp + gq, state.jl:4-8) ---------

    def sample_names(self, include_tp=True, include_gq=True):
        """CONSTRAINED-space draw names (``constrained_samples`` layout),
        matching BridgeStan's ``param_names``."""
        names = []
        for spec in self._params:
            if spec.shape:
                names += [f"{spec.name}[{i}]" for i in range(spec.size)]
            else:
                names.append(spec.name)
        if include_tp:
            names += self._block_var_names("transformed parameters")
        if include_gq:
            names += self._block_var_names("generated quantities")
        names.append("log_density")
        return names

    def unconstrained_sample_names(self):
        """Column labels for ``pt.sample_array()``, which holds the
        UNCONSTRAINED parameter vector: identity coordinates keep the
        parameter's name, transformed ones are suffixed ``_unc`` so a
        logit/log/cholesky-scale column is never mislabeled as the
        constrained value (ADVICE r4)."""
        names = []
        for spec in self._params:
            base = spec.name if spec.identity else f"{spec.name}_unc"
            if spec.unc_size == 1 and not spec.shape:
                names.append(base)
            else:
                names += [f"{base}[{i}]" for i in range(spec.unc_size)]
        names.append("log_density")
        return names

    def _block_var_names(self, block):
        names = []
        env, _ = self._constrain_env(jnp.zeros(self.dim))
        ev = _Evaluator(
            self._blocks.get("functions", []), rng=np.random.default_rng(0)
        )
        ev.exec_stmts(self._blocks.get(block, []), env)
        for s in self._blocks.get(block, []):
            if s[0] == "decl":
                v = env[s[1]]
                n = int(np.prod(np.shape(v))) if np.shape(v) else 1
                if np.shape(v):
                    names += [f"{s[1]}[{i}]" for i in range(n)]
                else:
                    names.append(s[1])
        return names

    def constrained_samples(self, pt, include_tp=True, include_gq=True, seed=0):
        """Reference ``param_constrain(...; include_tp, include_gq, rng)``:
        maps the run's unconstrained samples to a dict of constrained
        parameter draws plus transformed parameters and generated
        quantities (``state.jl:4-8``)."""
        sa = np.asarray(pt.sample_array())[:, : self.dim]
        rng = np.random.default_rng(seed)
        v_constrain = jax.jit(jax.vmap(lambda x: self._constrain_env(x)[0]))
        envs = v_constrain(jnp.asarray(sa))
        out = {}
        for spec in self._params:
            out[spec.name] = np.asarray(envs[spec.name])
        if include_tp:
            for s in self._blocks.get("transformed parameters", []):
                if s[0] == "decl":
                    out[s[1]] = np.asarray(envs[s[1]])
        if include_gq and self._blocks.get("generated quantities"):
            gq_names = [
                s[1] for s in self._blocks["generated quantities"] if s[0] == "decl"
            ]
            cols = {g: [] for g in gq_names}
            for i in range(sa.shape[0]):
                env = {
                    k: (np.asarray(v)[i] if np.ndim(v) else v)
                    for k, v in envs.items()
                }
                env = {**self._data_env, **env}
                ev = _Evaluator(self._blocks.get("functions", []), rng=rng)
                ev.exec_stmts(self._blocks["generated quantities"], env)
                for g in gq_names:
                    cols[g].append(np.asarray(env[g]))
            for g in gq_names:
                out[g] = np.stack(cols[g])
        return out


def load_stan_data(path: str) -> dict:
    """Read a Stan/CmdStan data file (JSON, e.g.
    ``examples/stan/bernoulli.data.json``)."""
    with open(path) as f:
        return json.load(f)


def stan_target(
    file: Optional[str] = None,
    source: Optional[str] = None,
    data: Optional[Any] = None,
    name: Optional[str] = None,
) -> StanTarget:
    """Build a target from a ``.stan`` file or source string; ``data`` is a
    dict or a path to a CmdStan-style JSON data file. The analogue of the
    reference's ``StanLogPotential(stan_file, data)``."""
    if (file is None) == (source is None):
        raise ValueError("pass exactly one of file= or source=")
    if file is not None:
        with open(file) as f:
            source = f.read()
        name = name or file.rsplit("/", 1)[-1].removesuffix(".stan")
    if isinstance(data, str):
        data = load_stan_data(data)
    return StanTarget(source, data=data, name=name or "stan_model")
