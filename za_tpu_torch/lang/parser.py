"""Preprocessor + lexer + recursive-descent parser for the Za language.

Reproduces the grammar in the reference LALRPOP definition
(parser/src/lang.lalrpop) including the 12-tier operator precedence,
``#[...]`` statement/template attributes, and signal-operator statements,
and the offset-preserving comment stripper (parser/src/parse.rs:6-73).
"""

from __future__ import annotations

import re
from typing import Optional

from .ast import (
    BDeclaration, BFunctionDef, BInclude, BTemplateDef, EArray, EFunctionCall,
    EInfixOp, ENumber, EPrefixOp, EVariable, Meta, Opcode, SBlock,
    SDeclaration, SFor, SIfThenElse, SInternalCall, SReturn, SSignalEq,
    SSignalLeft, SSignalRight, SSubstitution, SWhile, SelIndex, SelPin,
    SignalType, VariableP, VariableType,
)


class ParseError(Exception):
    def __init__(self, msg: str, meta: Meta):
        super().__init__(msg)
        self.msg = msg
        self.meta = meta


def preprocess(expr: str) -> str:
    """Strip comments while preserving byte offsets (parse.rs:6-73).

    Comment characters (including newlines inside block comments) are
    replaced by spaces; ``/*#[...]#*/`` unescapes to ``#[...]`` for circom
    compatibility.
    """
    expr = expr.replace("/*#[", "  #[").replace("]#*/", "]   ")
    out = []
    state = 0  # 0 normal, 1 line comment, 2 block comment
    block_comment_start = 0
    i = 0
    n = len(expr)
    while i < n:
        c0 = expr[i]
        if state == 0 and c0 == "/":
            c1 = expr[i + 1] if i + 1 < n else None
            if c1 == "/":
                state = 1
                out.append("  ")
                i += 2
                continue
            if c1 == "*":
                block_comment_start = i + 1
                state = 2
                out.append("  ")
                i += 2
                continue
            out.append(c0)
            i += 1
            continue
        if state == 0:
            out.append(c0)
        elif state == 1:
            if c0 == "\n":
                out.append(c0)
                state = 0
            else:
                out.append(" ")
        else:  # state == 2
            if c0 == "*" and i + 1 < n and expr[i + 1] == "/":
                out.append("  ")
                i += 2
                state = 0
                continue
            out.append(" ")
        i += 1
    if state == 2:
        raise ParseError(
            "unterminated /* */", Meta(block_comment_start, block_comment_start)
        )
    return "".join(out)


# -- lexer -------------------------------------------------------------------

KEYWORDS = {
    "include", "function", "template", "var", "component", "signal",
    "input", "private", "output", "if", "else", "for", "while", "return",
}

# multi-char operators, longest-match-first
_OPS = [
    "<<=", ">>=", "<==", "==>", "===", "<--", "-->",
    "**", "&&", "||", "==", "!=", "<=", ">=", "<<", ">>",
    "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=", "#[",
    "+", "-", "*", "/", "\\", "%", "<", ">", "=", "!", "&", "|", "^",
    "(", ")", "[", "]", "{", "}", ";", ",", ".",
]

_IDENT_RE = re.compile(r"[a-zA-Z][a-zA-Z$_0-9]*")
_HEX_RE = re.compile(r"0x[0-9A-Fa-f]*")
_DEC_RE = re.compile(r"[0-9]+")
_STR_RE = re.compile(r'"[^"]*"')
_WS_RE = re.compile(r"\s+")


class Token:
    __slots__ = ("kind", "text", "value", "start", "end")

    def __init__(self, kind: str, text: str, value, start: int, end: int):
        self.kind = kind  # 'op' | 'kw' | 'ident' | 'number' | 'string' | 'eof'
        self.text = text
        self.value = value
        self.start = start
        self.end = end

    def __repr__(self) -> str:
        return f"Token({self.kind},{self.text!r}@{self.start})"


def tokenize(src: str) -> list[Token]:
    toks: list[Token] = []
    i = 0
    n = len(src)
    while i < n:
        m = _WS_RE.match(src, i)
        if m:
            i = m.end()
            continue
        c = src[i]
        if c == '"':
            m = _STR_RE.match(src, i)
            if not m:
                raise ParseError("unterminated string", Meta(i, i))
            toks.append(Token("string", m.group(0), m.group(0)[1:-1], i, m.end()))
            i = m.end()
            continue
        if c.isdigit():
            m = _HEX_RE.match(src, i)
            if m and m.group(0) != "0x":
                toks.append(Token("number", m.group(0), int(m.group(0)[2:], 16), i, m.end()))
                i = m.end()
                continue
            m = _DEC_RE.match(src, i)
            toks.append(Token("number", m.group(0), int(m.group(0), 10), i, m.end()))
            i = m.end()
            continue
        if c.isalpha():
            m = _IDENT_RE.match(src, i)
            text = m.group(0)
            kind = "kw" if text in KEYWORDS else "ident"
            toks.append(Token(kind, text, text, i, m.end()))
            i = m.end()
            continue
        for op in _OPS:
            if src.startswith(op, i):
                toks.append(Token("op", op, op, i, i + len(op)))
                i += len(op)
                break
        else:
            raise ParseError(f"invalid token {c!r}", Meta(i, i + 1))
    toks.append(Token("eof", "", None, n, n))
    return toks


# -- parser ------------------------------------------------------------------

# operator tiers lowest-to-highest binding (lang.lalrpop:362-397)
_INFIX_TIERS = [
    {"||": Opcode.BOOLOR},
    {"&&": Opcode.BOOLAND},
    {"==": Opcode.EQ, "!=": Opcode.NOTEQ, "<": Opcode.LESSER,
     ">": Opcode.GREATER, "<=": Opcode.LESSEREQ, ">=": Opcode.GREATEREQ},
    {"|": Opcode.BITOR},
    {"^": Opcode.BITXOR},
    {"&": Opcode.BITAND},
    {"<<": Opcode.SHL, ">>": Opcode.SHR},
    {"+": Opcode.ADD, "-": Opcode.SUB},
    {"*": Opcode.MUL, "/": Opcode.DIV, "\\": Opcode.INTDIV, "%": Opcode.MOD},
    {"**": Opcode.POW},
]

_PREFIX_OPS = {"-": Opcode.SUB, "!": Opcode.BOOLNOT}

_ASSIG_OPS = {
    "=": Opcode.ASSIG, "+=": Opcode.ASSIG_ADD, "-=": Opcode.ASSIG_SUB,
    "*=": Opcode.ASSIG_MUL, "/=": Opcode.ASSIG_DIV, "%=": Opcode.ASSIG_MOD,
    "<<=": Opcode.ASSIG_SHL, ">>=": Opcode.ASSIG_SHR, "&=": Opcode.ASSIG_BITAND,
    "|=": Opcode.ASSIG_BITOR, "^=": Opcode.ASSIG_BITXOR,
}

_SIGNAL_LEFT_OPS = {"<--": Opcode.SIGNAL_WIRE_LEFT, "<==": Opcode.SIGNAL_CONSTRAIN_LEFT}
_SIGNAL_RIGHT_OPS = {"-->": Opcode.SIGNAL_WIRE_RIGHT, "==>": Opcode.SIGNAL_CONSTRAIN_RIGHT}


class _Parser:
    def __init__(self, src: str):
        self.toks = tokenize(src)
        self.pos = 0

    # helpers ---------------------------------------------------------------

    def peek(self, k: int = 0) -> Token:
        return self.toks[min(self.pos + k, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.toks[self.pos]
        if t.kind != "eof":
            self.pos += 1
        return t

    def at(self, text: str) -> bool:
        return self.peek().text == text and self.peek().kind in ("op", "kw")

    def expect(self, text: str) -> Token:
        t = self.peek()
        if t.text != text or t.kind not in ("op", "kw"):
            raise ParseError(
                f"expected {text!r}, found {t.text!r}", Meta(t.start, t.end)
            )
        return self.next()

    def expect_ident(self) -> Token:
        t = self.peek()
        if t.kind != "ident":
            raise ParseError(
                f"expected identifier, found {t.text!r}", Meta(t.start, t.end)
            )
        return self.next()

    def err(self, msg: str) -> ParseError:
        t = self.peek()
        return ParseError(f"{msg}, found {t.text!r}", Meta(t.start, t.end))

    def _pos(self) -> int:
        return self.peek().start

    def _end(self) -> int:
        # offset just after the previously consumed token
        if self.pos == 0:
            return 0
        return self.toks[self.pos - 1].end

    # attrs -----------------------------------------------------------------

    def parse_attrs(self) -> tuple[str, ...]:
        if not self.at("#["):
            return ()
        self.next()
        attrs = []
        while not self.at("]"):
            attrs.append(self.expect_ident().text)
            if self.at(","):
                self.next()
        self.expect("]")
        return tuple(attrs)

    # body ------------------------------------------------------------------

    def parse_body(self) -> list:
        out = []
        while self.peek().kind != "eof":
            out.append(self.parse_body_element())
        return out

    def parse_body_element(self):
        s = self._pos()
        if self.at("include"):
            self.next()
            t = self.peek()
            if t.kind != "string":
                raise self.err("expected string path")
            self.next()
            self.expect(";")
            return BInclude(Meta(s, self._end()), t.value)

        attrs = self.parse_attrs()
        s2 = s if attrs else self._pos()
        if self.at("function") or self.at("template"):
            kw = self.next().text
            name = self.expect_ident().text
            self.expect("(")
            args = []
            while not self.at(")"):
                args.append(self.expect_ident().text)
                if self.at(","):
                    self.next()
            self.expect(")")
            stmt = self.parse_block()
            meta = Meta(s2, self._end(), attrs)
            cls = BFunctionDef if kw == "function" else BTemplateDef
            return cls(meta, name, args, stmt)

        if self.at("var") or self.at("component") or self.at("signal"):
            decl = self.parse_declaration()
            self.expect(";")
            return BDeclaration(Meta(s2, self._end(), attrs), decl)

        raise self.err("expected body element")

    # declarations ----------------------------------------------------------

    def parse_declaration(self) -> SDeclaration:
        """Parse the Declaration production without trailing ';'."""
        s = self._pos()
        if self.at("var") or self.at("component"):
            xtype = (
                VariableType.VAR if self.next().text == "var" else VariableType.COMPONENT
            )
            name = self.parse_index_variable()
            init = None
            if self.at("="):
                if name.sels:
                    raise self.err("cannot initialize an indexed declaration")
                self.next()
                init = (Opcode.ASSIG, self.parse_expression())
            return SDeclaration(Meta(s, self._end()), xtype, None, name, init)

        if self.at("signal"):
            self.next()
            stype = SignalType.Internal
            if self.at("input"):
                self.next()
                stype = SignalType.PublicInput
            elif self.at("private"):
                self.next()
                self.expect("input")
                stype = SignalType.PrivateInput
            elif self.at("output"):
                self.next()
                stype = SignalType.Output
            name = self.parse_index_variable()
            return SDeclaration(
                Meta(s, self._end()), VariableType.SIGNAL, stype, name, None
            )

        raise self.err("expected declaration")

    def parse_index_variable(self) -> VariableP:
        """IDENT followed by [..] selectors only (IndexVariableDecl)."""
        s = self._pos()
        name = self.expect_ident().text
        sels = []
        while self.at("["):
            ss = self._pos()
            self.next()
            pos = self.parse_expression()
            self.expect("]")
            sels.append(SelIndex(Meta(ss, self._end()), pos))
        return VariableP(Meta(s, self._end()), name, sels)

    def parse_variable(self) -> VariableP:
        """IDENT followed by [..] / .pin selectors (Variable)."""
        s = self._pos()
        name = self.expect_ident().text
        sels = []
        while True:
            if self.at("["):
                ss = self._pos()
                self.next()
                pos = self.parse_expression()
                self.expect("]")
                sels.append(SelIndex(Meta(ss, self._end()), pos))
            elif self.at("."):
                ss = self._pos()
                self.next()
                pin = self.expect_ident().text
                sels.append(SelPin(Meta(ss, self._end()), pin))
            else:
                break
        return VariableP(Meta(s, self._end()), name, sels)

    # statements ------------------------------------------------------------

    def parse_block(self) -> SBlock:
        s = self._pos()
        self.expect("{")
        stmts = []
        while not self.at("}"):
            stmts.append(self.parse_statement())
        self.expect("}")
        return SBlock(Meta(s, self._end()), stmts)

    def parse_substitution(self) -> SSubstitution:
        s = self._pos()
        name = self.parse_variable()
        t = self.peek()
        if t.text not in _ASSIG_OPS or t.kind != "op":
            raise self.err("expected assignment operator")
        self.next()
        value = self.parse_expression()
        return SSubstitution(Meta(s, self._end()), name, _ASSIG_OPS[t.text], value)

    def parse_if_then_else(self, s: int, attrs: tuple[str, ...]) -> SIfThenElse:
        self.expect("(")
        xif = self.parse_expression()
        self.expect(")")
        xthen = self.parse_block()
        xelse = None
        if self.at("else"):
            self.next()
            if self.at("if"):
                es = self._pos()
                self.next()
                xelse = self.parse_if_then_else(es, ())
            else:
                xelse = self.parse_block()
        return SIfThenElse(Meta(s, self._end(), attrs), xif, xthen, xelse)

    def parse_statement(self):
        s = self._pos()
        attrs = self.parse_attrs()
        s = s if attrs else self._pos()

        if self.at("if"):
            self.next()
            return self.parse_if_then_else(s, attrs)

        if self.at("for"):
            self.next()
            self.expect("(")
            if self.at("var") or self.at("component") or self.at("signal"):
                init = self.parse_declaration()
            else:
                init = self.parse_substitution()
            self.expect(";")
            cond = self.parse_expression()
            self.expect(";")
            step = self.parse_substitution()
            self.expect(")")
            stmt = self.parse_block()
            return SFor(Meta(s, self._end(), attrs), init, cond, step, stmt)

        if self.at("while"):
            self.next()
            self.expect("(")
            cond = self.parse_expression()
            self.expect(")")
            stmt = self.parse_block()
            return SWhile(Meta(s, self._end(), attrs), cond, stmt)

        if self.at("return"):
            self.next()
            value = self.parse_expression()
            self.expect(";")
            return SReturn(Meta(s, self._end(), attrs), value)

        if self.at("var") or self.at("component") or self.at("signal"):
            decl = self.parse_declaration()
            self.expect(";")
            decl.meta = Meta(s, self._end(), attrs)
            return decl

        if self.at("{"):
            blk = self.parse_block()
            blk.meta = Meta(blk.meta.start, blk.meta.end, attrs)
            return blk

        # InternalCall: IDENT ! ( args ) ;
        if (
            self.peek().kind == "ident"
            and self.peek(1).text == "!"
            and self.peek(2).text == "("
        ):
            name = self.next().text
            self.next()  # !
            self.next()  # (
            args = self.parse_expression_list(")")
            self.expect(")")
            self.expect(";")
            return SInternalCall(Meta(s, self._end(), attrs), name, args)

        # expression-led statements
        lhe = self.parse_expression()
        t = self.peek()
        if t.kind == "op" and t.text in _ASSIG_OPS:
            if not isinstance(lhe, EVariable):
                raise self.err("left side of assignment must be a variable")
            self.next()
            value = self.parse_expression()
            self.expect(";")
            return SSubstitution(
                Meta(s, self._end(), attrs), lhe.name, _ASSIG_OPS[t.text], value
            )
        if t.kind == "op" and t.text in _SIGNAL_LEFT_OPS:
            if not isinstance(lhe, EVariable):
                raise self.err("left side of signal assignment must be a variable")
            self.next()
            value = self.parse_expression()
            self.expect(";")
            return SSignalLeft(
                Meta(s, self._end(), attrs), lhe.name, _SIGNAL_LEFT_OPS[t.text], value
            )
        if t.kind == "op" and t.text in _SIGNAL_RIGHT_OPS:
            self.next()
            name = self.parse_variable()
            self.expect(";")
            return SSignalRight(
                Meta(s, self._end(), attrs), lhe, _SIGNAL_RIGHT_OPS[t.text], name
            )
        if t.kind == "op" and t.text == "===":
            self.next()
            rhe = self.parse_expression()
            self.expect(";")
            return SSignalEq(
                Meta(s, self._end(), attrs), lhe, Opcode.SIGNAL_CONSTRAIN_EQ, rhe
            )
        raise self.err("expected statement")

    # expressions ------------------------------------------------------------

    def parse_expression_list(self, closer: str) -> list:
        args = []
        while not self.at(closer):
            args.append(self.parse_expression())
            if self.at(","):
                self.next()
            else:
                break
        return args

    def parse_expression(self):
        return self._parse_tier(0)

    def _parse_tier(self, tier: int):
        if tier == len(_INFIX_TIERS):
            return self._parse_prefix()
        ops = _INFIX_TIERS[tier]
        s = self._pos()
        lhe = self._parse_tier(tier + 1)
        while True:
            t = self.peek()
            if t.kind == "op" and t.text in ops:
                self.next()
                rhe = self._parse_tier(tier + 1)
                lhe = EInfixOp(Meta(s, self._end()), lhe, ops[t.text], rhe)
            else:
                return lhe

    def _parse_prefix(self):
        t = self.peek()
        if t.kind == "op" and t.text in _PREFIX_OPS:
            s = self._pos()
            self.next()
            rhe = self._parse_primary()
            return EPrefixOp(Meta(s, self._end()), _PREFIX_OPS[t.text], rhe)
        return self._parse_primary()

    def _parse_primary(self):
        s = self._pos()
        t = self.peek()
        # function call
        if t.kind == "ident" and self.peek(1).text == "(":
            name = self.next().text
            self.next()  # (
            args = self.parse_expression_list(")")
            self.expect(")")
            return EFunctionCall(Meta(s, self._end()), name, args)
        # array literal
        if t.kind == "op" and t.text == "[":
            self.next()
            values = self.parse_expression_list("]")
            self.expect("]")
            return EArray(Meta(s, self._end()), values)
        # parentheses
        if t.kind == "op" and t.text == "(":
            self.next()
            e = self.parse_expression()
            self.expect(")")
            return e
        # number
        if t.kind == "number":
            self.next()
            return ENumber(Meta(s, self._end()), t.value)
        # variable
        if t.kind == "ident":
            var = self.parse_variable()
            return EVariable(Meta(s, self._end()), var)
        raise self.err("expected expression")


def parse(src: str) -> list:
    """Parse Za source into a list of body elements.

    Entry point equivalent of the reference ``za_parser::parse``
    (parser/src/parse.rs:76-93); raises ParseError with a Meta span.
    """
    return _Parser(preprocess(src)).parse_body()


def parse_statement(src: str):
    """Parse a single statement (test helper, mirrors StatementParser)."""
    return _Parser(preprocess(src)).parse_statement()


def parse_expression(src: str):
    """Parse a single expression (test helper, mirrors ExpressionParser)."""
    return _Parser(preprocess(src)).parse_expression()
