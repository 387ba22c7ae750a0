"""The dry-run word-level tokenizer in pure Python.

Counterpart of ``tools/make_random_7b_ckpt.py::build_dry_run_tokenizer``,
which builds the same tokenizer with the ``tokenizers`` and
``transformers`` packages so the random-weights 7B drivers run the
text-level API without a download. The port needs only PyTorch, so it
carries this copy; ``tests/test_torch_pipeline.py`` pins its ids and decoded
text equal to the original's.

The rules of the original:
- vocabulary: the word list below, first occurrence wins;
- pre-tokenizer ``Whitespace``: ``\\w+|[^\\w\\s]+``;
- unknown words -> ``<unk>``; ``<s>`` is prepended when
  ``add_special_tokens``;
- decode joins tokens with single spaces, drops ids outside the vocabulary
  and, with ``skip_special_tokens``, ``<unk>``, ``<s>`` and ``</s>``.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List

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


class DryRunTokenizer:
    """Word-level tokenizer with the dry-run vocabulary (ids < 90)."""

    def __init__(self):
        vocab: Dict[str, int] = {}
        for w in _WORDS:
            vocab.setdefault(w, len(vocab))
        self.vocab = vocab
        self.id_to_token = {i: w for w, i in vocab.items()}
        self.all_special_ids = [vocab[t] for t in ("<s>", "</s>", "<unk>")]
        self.bos_token_id = vocab["<s>"]
        self.unk_token_id = vocab["<unk>"]

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        ids = [self.vocab.get(w, self.unk_token_id)
               for w in _PRETOKENIZE.findall(text)]
        return ([self.bos_token_id] + ids) if add_special_tokens else ids

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False) -> str:
        skip = set(self.all_special_ids) if skip_special_tokens else set()
        words = [self.id_to_token[i] for i in map(int, ids)
                 if i in self.id_to_token and i not in skip]
        return " ".join(words)
