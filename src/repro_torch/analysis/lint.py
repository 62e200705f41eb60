"""Repo-specific lint rules over ``src/repro_torch`` (DESIGN.md §17): the
port of ``repro.analysis.lint``, with one rule for the CUDA sources.

Run as ``python -m repro_torch.analysis.lint [paths...]`` (default
``src/repro_torch`` relative to the current directory); exits 1 if any
finding.  Rules (the reference's ids, over the port's paths):

- **LNT-BITMASK** — no magic all-ones bit-mask literals (``0xF``,
  ``0x7FF``, ...) in ``core/transport`` outside ``wire_format.py``: every
  field width/mask/shift has exactly one home, so a field resize can't
  leave a stale literal behind.
- **LNT-SCALE-DIV** — no float division by a constant-like divisor inside
  quantization-scale code (codec / quantize_pack / compression): a
  compiler may fold ``x / QMAX`` with other rounding than the eager path
  (1-ULP drift between two paths); scale math must multiply by a
  precomputed reciprocal.  Module-level constants (the reciprocal itself)
  are exempt.
- **LNT-ASSERT-PROTO** — no bare ``assert`` referencing protocol-width
  constants (SEQ_MOD, IMM_VAL_MAX, FENCE_COUNT_MAX, N_CHANNELS_MAX, ...)
  in ``core/transport``: those checks vanish under ``python -O`` and must
  be explicit :class:`ProtocolError` raises (or verifier rules).
- **LNT-PL-WHEN** — Pallas kernels (``*_kernel`` functions in
  ``kernels/``) taking an occupancy/count ref must gate their work with
  ``pl.when``.  The port has no Pallas kernel; the rule stays for the
  Python sources it would apply to.
- **LNT-CU-OCC** — the same rule for the hand-written CUDA kernels: a
  ``__global__`` function in a ``.cu``/``.cuh`` source taking a count
  parameter (``cnt``, ``counts``, ``occ``, ``occupancy``, or a name whose
  first ``_`` part is one of them) must branch on the count (an ``if``
  whose condition reads it, through any local computed from it, to return,
  continue, break or skip the work under it) or bound a loop by it, itself
  or in a ``__device__`` helper it passes the count to, so that rows past
  occupancy are neither loaded nor computed.
- **LNT-PARSE** — a Python source that does not parse.
"""
from __future__ import annotations

import ast
import io
import os
import re
import sys
import tokenize
from dataclasses import dataclass

PROTOCOL_NAMES = frozenset({
    "SEQ_MOD", "IMM_VAL_MAX", "FENCE_COUNT_MAX", "N_CHANNELS_MAX",
    "SRD_DISPLACEMENT_BOUND", "IMM_KIND_BITS", "IMM_CH_BITS",
    "IMM_SEQ_BITS", "IMM_VALUE_BITS", "IMM_COUNT_BITS",
})

# modules holding quantization-scale math (matched on basename)
_QUANT_BASENAMES = frozenset({"codec.py", "quantize_pack.py",
                              "compression.py"})

# smallest all-ones literal worth flagging (0x1/0x3/0x7 are ubiquitous
# small-flag idioms; field masks start at 4 bits)
_MIN_MASK = 0xF


@dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    rule: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"


def _posix(path: str) -> str:
    return path.replace(os.sep, "/")


def _in_transport(path: str) -> bool:
    p = _posix(path)
    return "core/transport" in p and os.path.basename(p) != "wire_format.py"


def _in_kernels(path: str) -> bool:
    return "kernels" in _posix(path).split("/")


def _is_quant_module(path: str) -> bool:
    return os.path.basename(path) in _QUANT_BASENAMES


# ------------------------------------------------------------------------
# LNT-BITMASK (token level: the AST constant-folds literal forms away)
# ------------------------------------------------------------------------
def _check_bitmask(src: str, path: str) -> list[LintFinding]:
    if not _in_transport(path):
        return []
    out = []
    for tok in tokenize.generate_tokens(io.StringIO(src).readline):
        if tok.type != tokenize.NUMBER:
            continue
        s = tok.string.lower().replace("_", "")
        if not (s.startswith("0x") or s.startswith("0b")):
            continue
        try:
            v = int(s, 0)
        except ValueError:
            continue
        if v >= _MIN_MASK and (v & (v + 1)) == 0:
            out.append(LintFinding(
                path, tok.start[0], "LNT-BITMASK",
                f"magic bit-mask literal {tok.string}: import the named "
                "mask from core/transport/wire_format.py"))
    return out


# ------------------------------------------------------------------------
# LNT-SCALE-DIV
# ------------------------------------------------------------------------
def _constant_like(node: ast.expr) -> bool:
    """Divisors a compiler can constant-fold differently from the eager path:
    numeric literals, ALL_CAPS module constants, and casts/calls wrapping
    those (``np.float32(FP8_MAX)``)."""
    if isinstance(node, ast.Constant) and isinstance(node.value, (int, float)):
        return True
    if isinstance(node, ast.Name) and node.id.isupper():
        return True
    if isinstance(node, ast.Attribute) and node.attr.isupper():
        return True
    if isinstance(node, ast.Call):
        return any(_constant_like(a) for a in node.args)
    return False


def _check_scale_div(tree: ast.AST, path: str) -> list[LintFinding]:
    if not _is_quant_module(path):
        return []
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue        # module-level reciprocals (_QINV) are the fix
        for node in ast.walk(fn):
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, ast.Div) \
                    and _constant_like(node.right):
                out.append(LintFinding(
                    path, node.lineno, "LNT-SCALE-DIV",
                    "float division by a constant in quantization-scale "
                    "math: precompute the reciprocal at module level and "
                    "multiply (a compiler may fold x / C with other "
                    "rounding than the eager path: the 1-ULP drift "
                    "class)"))
    return out


# ------------------------------------------------------------------------
# LNT-ASSERT-PROTO
# ------------------------------------------------------------------------
def _check_assert_proto(tree: ast.AST, path: str) -> list[LintFinding]:
    if not _in_transport(path):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Assert):
            continue
        names = {n.id for n in ast.walk(node.test)
                 if isinstance(n, ast.Name)}
        hit = names & PROTOCOL_NAMES
        if hit:
            out.append(LintFinding(
                path, node.lineno, "LNT-ASSERT-PROTO",
                f"bare assert references protocol constant(s) "
                f"{sorted(hit)}: asserts vanish under python -O — raise "
                "ProtocolError (wire_format) or verify via "
                "repro_torch.analysis.verify"))
    return out


# ------------------------------------------------------------------------
# LNT-PL-WHEN
# ------------------------------------------------------------------------
def _takes_occupancy(fn: ast.FunctionDef) -> bool:
    args = [a.arg for a in
            fn.args.posonlyargs + fn.args.args + fn.args.kwonlyargs]
    return any(a.split("_")[0] in ("cnt", "counts", "occ", "occupancy")
               for a in args)


def _uses_pl_when(fn: ast.FunctionDef) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Attribute) and node.attr == "when" \
                and isinstance(node.value, ast.Name) \
                and node.value.id == "pl":
            return True
    return False


def _check_pl_when(tree: ast.AST, path: str) -> list[LintFinding]:
    if not _in_kernels(path):
        return []
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef) \
                or not fn.name.endswith("_kernel"):
            continue
        if _takes_occupancy(fn) and not _uses_pl_when(fn):
            out.append(LintFinding(
                path, fn.lineno, "LNT-PL-WHEN",
                f"Pallas kernel {fn.name} takes an occupancy/count ref but "
                "never guards with pl.when: rows past occupancy hold "
                "padding garbage"))
    return out


# ------------------------------------------------------------------------
# LNT-CU-OCC (the CUDA sources: a scan of the text, no C++ parser)
# ------------------------------------------------------------------------
_CUDA_SUFFIXES = (".cu", ".cuh")
_OCC_PREFIXES = ("cnt", "counts", "occ", "occupancy")
_IDENT = re.compile(r"[A-Za-z_]\w*")
# attribute-like calls in a function's head that are not its name
_NOT_NAMES = frozenset({"__launch_bounds__", "__align__", "alignas",
                        "__declspec", "__attribute__"})
_KEYWORDS = frozenset({"if", "for", "while", "switch", "return", "sizeof",
                       "static_cast", "reinterpret_cast", "const_cast"})


@dataclass(frozen=True)
class _CuFunction:
    name: str
    line: int
    is_global: bool
    params: tuple      # parameter names, in order
    body: str          # between the braces


def _strip_c(src: str) -> str:
    """Comments and string/char literals blanked, newlines kept (so that
    offsets still map to lines)."""
    out, i, n = [], 0, len(src)
    while i < n:
        c, nxt = src[i], src[i:i + 2]
        if nxt == "//":
            j = src.find("\n", i)
            j = n if j < 0 else j
            out.append(" " * (j - i))
            i = j
        elif nxt == "/*":
            j = src.find("*/", i + 2)
            j = n if j < 0 else j + 2
            out.append("".join(ch if ch == "\n" else " " for ch in src[i:j]))
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and src[j] != c:
                j += 2 if src[j] == "\\" else 1
            out.append(c + " " * (min(j, n) - i - 1) + (c if j < n else ""))
            i = j + 1
        else:
            out.append(c)
            i += 1
    return "".join(out)


def _match(text: str, i: int, open_: str, close: str) -> int:
    """Index just past the bracket that closes the one at ``text[i]``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_:
            depth += 1
        elif text[j] == close:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def _split_top(text: str, angle: bool = False) -> list[str]:
    """``text`` split at the commas outside any bracket (and, with
    ``angle``, outside template arguments: a parameter list, where ``<``
    is no comparison)."""
    opens, closes = ("([{<", ")]}>") if angle else ("([{", ")]}")
    parts, depth, cur = [], 0, []
    for ch in text:
        if ch in opens:
            depth += 1
        elif ch in closes:
            depth -= 1
        if ch == "," and depth == 0:
            parts.append("".join(cur))
            cur = []
        else:
            cur.append(ch)
    if "".join(cur).strip():
        parts.append("".join(cur))
    return parts


def _param_name(param: str) -> str:
    p = re.sub(r"\[[^\]]*\]", "", param.split("=")[0])
    names = _IDENT.findall(p)
    return names[-1] if names else ""


def _cu_functions(text: str) -> list[_CuFunction]:
    """The ``__global__`` and ``__device__`` function definitions of a
    stripped source."""
    out = []
    for m in re.finditer(r"\b(__global__|__device__)\b", text):
        # the head runs to the first ';' or '{' outside parentheses
        i, depth = m.end(), 0
        while i < len(text):
            ch = text[i]
            if ch == "(":
                depth += 1
            elif ch == ")":
                depth -= 1
            elif depth == 0 and ch in ";{=":
                break
            i += 1
        if i >= len(text) or text[i] != "{":
            continue                      # a declaration or a variable
        head = text[m.end():i]
        name, params = "", ""
        for c in re.finditer(r"([A-Za-z_]\w*)\s*\(", head):
            if c.group(1) in _NOT_NAMES:
                continue
            j = _match(head, c.end() - 1, "(", ")")
            name, params = c.group(1), head[c.end():j - 1]
        if not name:
            continue
        end = _match(text, i, "{", "}")
        out.append(_CuFunction(
            name, text.count("\n", 0, m.start()) + 1,
            m.group(1) == "__global__",
            tuple(_param_name(p) for p in _split_top(params, angle=True)),
            text[i + 1:end - 1]))
    return out


def _mentions(expr: str, names: set) -> bool:
    return any(t in names for t in _IDENT.findall(expr))


def _enclosed(rhs: str) -> str:
    """``rhs`` up to the first parenthesis it does not open (the end of a
    ``for`` head's step, ``for (...; r += s)``)."""
    depth = 0
    for i, ch in enumerate(rhs):
        depth += (ch == "(") - (ch == ")")
        if depth < 0:
            return rhs[:i]
    return rhs


def _tainted(body: str, seeds: set) -> set:
    """The count names and every local assigned from an expression that
    reads one of them (to a fixed point)."""
    names = set(seeds)
    assigns = [(m.group(1), _enclosed(m.group(2))) for m in re.finditer(
        r"([A-Za-z_]\w*)\s*(?:\[[^\]]*\])?\s*(?:[-+*/|&^]|<<|>>)?=(?!=)"
        r"([^;{}]*)", body)]
    grew = True
    while grew:
        grew = False
        for lhs, rhs in assigns:
            if lhs not in names and _mentions(rhs, names):
                names.add(lhs)
                grew = True
    return names


def _guards(body: str, names: set) -> bool:
    """An ``if`` whose condition reads a count name (returning, continuing,
    breaking or skipping the statement under it), or a ``for``/``while``
    whose condition reads one."""
    for m in re.finditer(r"\b(if|for|while)\s*\(", body):
        j = _match(body, m.end() - 1, "(", ")")
        cond = body[m.end():j - 1]
        if m.group(1) == "for":
            parts = cond.split(";")
            cond = parts[1] if len(parts) == 3 else ""
        if _mentions(cond, names):
            return True
    return False


def _calls(body: str):
    """(callee, [argument text]) of every call in ``body``."""
    for m in re.finditer(r"\b([A-Za-z_]\w*)\s*(<[^<>;(){}]*>)?\s*\(", body):
        if m.group(1) in _KEYWORDS:
            continue
        j = _match(body, m.end() - 1, "(", ")")
        yield m.group(1), _split_top(body[m.end():j - 1])


def _included(text: str, path: str) -> str:
    """The stripped text of the quoted ``#include`` files found beside
    ``path`` (one level), where the helpers a kernel calls may live."""
    out = []
    for m in re.finditer(r'#\s*include\s*"([^"]+)"', text):
        fp = os.path.join(os.path.dirname(path), m.group(1))
        if os.path.isfile(fp):
            with open(fp, encoding="utf-8") as fh:
                out.append(_strip_c(fh.read()))
    return "\n".join(out)


def _guarded(fn: _CuFunction, seeds: set, helpers: dict,
             seen: frozenset = frozenset()) -> bool:
    names = _tainted(fn.body, seeds)
    if _guards(fn.body, names):
        return True
    for callee, args in _calls(fn.body):
        for h in helpers.get(callee, ()):
            if (h.name, h.line) in seen or len(h.params) != len(args):
                continue
            hs = {p for p, a in zip(h.params, args) if _mentions(a, names)}
            if hs and _guarded(h, hs, helpers, seen | {(h.name, h.line)}):
                return True
    return False


def _check_cu_occ(src: str, path: str) -> list[LintFinding]:
    text = _strip_c(src)
    fns = _cu_functions(text)
    helpers: dict = {}
    for h in fns + _cu_functions(_strip_c(_included(src, path))):
        if not h.is_global:
            helpers.setdefault(h.name, []).append(h)
    out = []
    for fn in fns:
        seeds = {p for p in fn.params
                 if p.split("_")[0] in _OCC_PREFIXES}
        if fn.is_global and seeds and not _guarded(fn, seeds, helpers):
            out.append(LintFinding(
                path, fn.line, "LNT-CU-OCC",
                f"CUDA kernel {fn.name} takes a count "
                f"({', '.join(sorted(seeds))}) but never branches on it or "
                "bounds a loop by it: rows past occupancy are loaded and "
                "computed"))
    return out


# ------------------------------------------------------------------------
# entry points
# ------------------------------------------------------------------------
def lint_source(src: str, path: str) -> list[LintFinding]:
    """Lint one file's source under its (relative) ``path`` — the path
    decides which rules apply; a ``.cu``/``.cuh`` path takes the CUDA rule
    alone.  Unparseable Python files produce a single finding rather than
    a crash."""
    if path.endswith(_CUDA_SUFFIXES):
        return _check_cu_occ(src, path)
    findings = list(_check_bitmask(src, path))
    try:
        tree = ast.parse(src)
    except SyntaxError as e:
        return findings + [LintFinding(path, e.lineno or 0, "LNT-PARSE",
                                       f"syntax error: {e.msg}")]
    findings += _check_scale_div(tree, path)
    findings += _check_assert_proto(tree, path)
    findings += _check_pl_when(tree, path)
    return findings


def lint_paths(paths: list[str]) -> list[LintFinding]:
    findings: list[LintFinding] = []
    for root in paths:
        if os.path.isfile(root):
            files = [root]
        else:
            files = sorted(
                os.path.join(dp, f)
                for dp, _, fs in os.walk(root) for f in fs
                if f.endswith((".py",) + _CUDA_SUFFIXES))
        for fp in files:
            with open(fp, encoding="utf-8") as fh:
                findings += lint_source(fh.read(), fp)
    findings.sort(key=lambda f: (f.path, f.line))
    return findings


def main(argv: list[str]) -> int:
    paths = argv or ["src/repro_torch"]
    findings = lint_paths(paths)
    for f in findings:
        print(f)
    n_files = sum(1 for _ in {f.path for f in findings})
    if findings:
        print(f"lint: {len(findings)} finding(s) in {n_files} file(s)")
        return 1
    print(f"lint: clean ({', '.join(paths)})")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
