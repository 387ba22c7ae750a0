"""The dry-run word-level tokenizer in pure Python, and its files.

Counterpart of ``tools/make_random_7b_ckpt.py::build_dry_run_tokenizer``,
which builds the same tokenizer with the ``tokenizers`` and
``transformers`` packages so the random-weights 7B drivers run the
text-level API without a download. The port needs only PyTorch, so it
carries this copy; ``tests/test_torch_pipeline.py`` pins its ids and decoded
text equal to the original's.

The rules of the original (HF ``WordLevel`` model, ``Whitespace``
pre-tokenizer, ``TemplateProcessing`` post-processor ``<s> $A``):
- vocabulary: the word list below, first occurrence wins;
- the special tokens (``<unk>``, ``<s>``, ``</s>``) are matched whole in the
  text first, then the rest is pre-tokenized by ``\\w+|[^\\w\\s]+``;
- unknown words -> ``<unk>``; ``<s>`` is prepended when
  ``add_special_tokens``;
- decode joins tokens with single spaces, drops ids outside the vocabulary
  and, with ``skip_special_tokens``, the special tokens.

``save_pretrained`` writes HF's files for it (``tokenizer.json``,
``tokenizer_config.json``, ``special_tokens_map.json``), which
``tokenizers.Tokenizer.from_file`` and ``transformers.AutoTokenizer`` read;
``from_pretrained`` reads any ``tokenizer.json`` of that form (its own
vocabulary and special tokens), such as one that
``build_dry_run_tokenizer().save_pretrained`` wrote, and returns None for
any other tokenizer.
"""

from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

_WORDS = (
    "<unk> <s> </s>".split()
    + list("abcdefghijklmnopqrstuvwxyz0123456789")
    + list(".,:;?!'\"()-")
    + ("USER ASSISTANT A chat between a curious human and an artificial "
       "intelligence assistant . The gives helpful detailed polite "
       "answers to the user s questions what is shown here read label "
       "text code on tag in image Answer single word or key phrase").split()
)
_PRETOKENIZE = re.compile(r"\w+|[^\w\s]+")
_ROLES = ("bos_token", "eos_token", "unk_token", "pad_token")


def _dry_run_vocab() -> Dict[str, int]:
    vocab: Dict[str, int] = {}
    for w in _WORDS:
        vocab.setdefault(w, len(vocab))
    return vocab


class DryRunTokenizer:
    """Word-level tokenizer; by default the dry-run vocabulary (ids < 90)
    and its special tokens."""

    def __init__(self, vocab: Optional[Dict[str, int]] = None, unk_token: str = "<unk>",
                 bos_token: Optional[str] = "<s>", eos_token: Optional[str] = "</s>",
                 pad_token: Optional[str] = "<unk>",
                 prefix: Optional[Sequence[str]] = None):
        self.vocab = dict(_dry_run_vocab() if vocab is None else vocab)
        self.id_to_token = {i: w for w, i in self.vocab.items()}
        self.unk_token, self.bos_token = unk_token, bos_token
        self.eos_token, self.pad_token = eos_token, pad_token
        for role in _ROLES:
            tok = getattr(self, role)
            setattr(self, f"{role}_id", None if tok is None else self.vocab[tok])
        specials = [getattr(self, r) for r in _ROLES if getattr(self, r) is not None]
        self.special_tokens = list(dict.fromkeys(specials))
        self.all_special_ids = [self.vocab[t] for t in self.special_tokens]
        # what TemplateProcessing puts before the text with add_special_tokens
        self.prefix = [bos_token] if prefix is None and bos_token else list(prefix or [])
        self._split = re.compile("(" + ("|".join(
            re.escape(t) for t in sorted(self.special_tokens, key=len, reverse=True)) or "(?!)")
            + ")")

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab[t] for t in self.prefix] if add_special_tokens else []
        for i, piece in enumerate(self._split.split(text)):
            if i % 2:                                    # a special token, whole
                ids.append(self.vocab[piece])
            else:
                ids += [self.vocab.get(w, self.unk_token_id) for w in _PRETOKENIZE.findall(piece)]
        return ids

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        skip = set(self.all_special_ids) if skip_special_tokens else set()
        words = [self.id_to_token[i] for i in map(int, ids)
                 if i in self.id_to_token and i not in skip]
        return " ".join(words)

    # ── HF's files ─────────────────────────────────────────────────────
    def save_pretrained(self, path) -> None:
        """``tokenizer.json``, ``tokenizer_config.json`` and
        ``special_tokens_map.json`` into directory ``path``, as a
        ``transformers`` ``PreTrainedTokenizerFast`` of this tokenizer
        writes them."""
        p = Path(path)
        p.mkdir(parents=True, exist_ok=True)
        added = [{"id": self.vocab[t], "content": t, "single_word": False, "lstrip": False,
                  "rstrip": False, "normalized": False, "special": True}
                 for t in self.special_tokens]
        post = None
        if self.prefix:
            head = [{"SpecialToken": {"id": t, "type_id": 0}} for t in self.prefix]
            post = {"type": "TemplateProcessing",
                    "single": head + [{"Sequence": {"id": "A", "type_id": 0}}],
                    "pair": head + [{"Sequence": {"id": "A", "type_id": 0}},
                                    {"Sequence": {"id": "B", "type_id": 0}}],
                    "special_tokens": {t: {"id": t, "ids": [self.vocab[t]], "tokens": [t]}
                                       for t in dict.fromkeys(self.prefix)}}
        tokenizer = {"version": "1.0", "truncation": None, "padding": None,
                     "added_tokens": added, "normalizer": None,
                     "pre_tokenizer": {"type": "Whitespace"}, "post_processor": post,
                     "decoder": None,
                     "model": {"type": "WordLevel", "vocab": self.vocab,
                               "unk_token": self.unk_token}}
        roles = {r: getattr(self, r) for r in _ROLES if getattr(self, r) is not None}
        config = {"added_tokens_decoder": {str(a["id"]): {k: v for k, v in a.items() if k != "id"}
                                           for a in added},
                  **roles, "clean_up_tokenization_spaces": False,
                  "tokenizer_class": "PreTrainedTokenizerFast"}
        for name, obj in (("tokenizer.json", tokenizer), ("tokenizer_config.json", config),
                          ("special_tokens_map.json", roles)):
            with open(p / name, "w", encoding="utf-8") as f:
                json.dump(obj, f, indent=2, ensure_ascii=False)

    @classmethod
    def from_pretrained(cls, path) -> Optional["DryRunTokenizer"]:
        """The tokenizer of directory ``path`` where its ``tokenizer.json``
        is a ``WordLevel`` model with the ``Whitespace`` pre-tokenizer, no
        normalizer or decoder, and no post-processor or a
        ``TemplateProcessing`` one that only prepends special tokens; None
        for any other directory."""
        p = Path(path)
        if not (p / "tokenizer.json").is_file():
            return None
        with open(p / "tokenizer.json", encoding="utf-8") as f:
            tj = json.load(f)
        model, post = tj.get("model") or {}, tj.get("post_processor")
        if (model.get("type") != "WordLevel" or tj.get("pre_tokenizer") != {"type": "Whitespace"}
                or tj.get("normalizer") is not None or tj.get("decoder") is not None):
            return None
        if any(a.get(k) for a in tj.get("added_tokens", [])
               for k in ("single_word", "lstrip", "rstrip")):
            return None
        prefix: List[str] = []
        if post is not None:
            if post.get("type") != "TemplateProcessing":
                return None
            single = post["single"]
            if not single or "Sequence" not in single[-1]:
                return None                              # a suffix: not this form
            prefix = [item["SpecialToken"]["id"] for item in single[:-1]]
        config = {}
        for name in ("special_tokens_map.json", "tokenizer_config.json"):
            if (p / name).is_file():
                with open(p / name, encoding="utf-8") as f:
                    config.update(json.load(f))
        if config.get("clean_up_tokenization_spaces"):
            return None

        def role(name, default=None):
            tok = config.get(name, default)
            return tok["content"] if isinstance(tok, dict) else tok

        roles = {role(r, model.get("unk_token") if r == "unk_token" else None) for r in _ROLES}
        if not {a["content"] for a in tj.get("added_tokens", [])} <= roles:
            return None                                  # tokens matched whole besides these
        vocab = dict(model["vocab"])
        for a in tj.get("added_tokens", []):
            vocab.setdefault(a["content"], a["id"])
        return cls(vocab, unk_token=role("unk_token", model.get("unk_token")),
                   bos_token=role("bos_token"), eos_token=role("eos_token"),
                   pad_token=role("pad_token"), prefix=prefix)
