"""A model directory's Jinja chat template, rendered as transformers'
`apply_chat_template(messages, tokenize=False, add_generation_prompt=True)`
renders it (the port's counterpart of the call in cake_tpu/runtime.py;
the card's machine has no `transformers`).

Set up as transformers sets it up: an ImmutableSandboxedEnvironment with
trim_blocks, lstrip_blocks, the loopcontrols extension and a
`{% generation %}` block (rendered as its body: the port asks for no
assistant mask), a `tojson`
filter that keeps non-ASCII text, the `raise_exception` and
`strftime_now` globals, and the special tokens of tokenizer_config.json
(bos_token, eos_token, ...) as variables. `jinja2` is imported only when
a template is built. A template that does not compile raises.
"""
from __future__ import annotations

import json
from datetime import datetime

SPECIAL_TOKEN_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                      "pad_token", "cls_token", "mask_token")


def _tojson(x, ensure_ascii=False, indent=None, separators=None,
            sort_keys=False):
    return json.dumps(x, ensure_ascii=ensure_ascii, indent=indent,
                      separators=separators, sort_keys=sort_keys)


def _raise_exception(message):
    import jinja2
    raise jinja2.exceptions.TemplateError(message)


def _strftime_now(fmt):
    return datetime.now().strftime(fmt)


def _token_text(v):
    """A special token as tokenizer_config.json stores it: a string or an
    AddedToken dict."""
    if isinstance(v, dict):
        return v.get("content")
    return v


def special_tokens(tokenizer_config: dict) -> dict:
    """{name: text} of the special tokens a template may read."""
    out = {}
    for key in SPECIAL_TOKEN_KEYS:
        text = _token_text(tokenizer_config.get(key))
        if text is not None:
            out[key] = text
    extra = tokenizer_config.get("additional_special_tokens")
    if extra:
        out["additional_special_tokens"] = [_token_text(t) for t in extra]
    return out


def template_source(tokenizer_config: dict) -> str | None:
    """The config's chat template: a string, or the "default" entry of a
    list of named templates."""
    t = tokenizer_config.get("chat_template")
    if isinstance(t, list):
        named = {e.get("name"): e.get("template") for e in t}
        return named.get("default")
    return t or None


class ChatTemplate:
    def __init__(self, source: str, tokens: dict | None = None):
        import jinja2
        from jinja2.ext import Extension, loopcontrols
        from jinja2.sandbox import ImmutableSandboxedEnvironment

        class Generation(Extension):
            tags = {"generation"}

            def parse(self, parser):
                lineno = next(parser.stream).lineno
                body = parser.parse_statements(("name:endgeneration",),
                                               drop_needle=True)
                return jinja2.nodes.CallBlock(
                    self.call_method("_body"), [], [], body
                ).set_lineno(lineno)

            def _body(self, caller):
                return caller()
        env = ImmutableSandboxedEnvironment(
            trim_blocks=True, lstrip_blocks=True,
            extensions=[Generation, loopcontrols])
        env.filters["tojson"] = _tojson
        env.globals["raise_exception"] = _raise_exception
        env.globals["strftime_now"] = _strftime_now
        try:
            self._template = env.from_string(source)
        except jinja2.TemplateError as e:
            raise ValueError(f"chat template does not compile: {e}") from e
        self.tokens = dict(tokens or {})

    def render(self, messages: list[dict],
               add_generation_prompt: bool = True) -> str:
        return self._template.render(
            messages=messages, tools=None, documents=None,
            add_generation_prompt=add_generation_prompt, **self.tokens)
