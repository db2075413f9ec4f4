"""The 71-character alphabet for char-level report encoding (a copy of
``mopoe_mimic_tpu/data/alphabet.py``).

The reference loads ``mimic/alphabet.json`` (mimic/utils/utils.py:166-169)
but that file is absent from the snapshot. The encode/decode contract is
pinned by mimic/utils/text.py:13-34: '$' marks end-of-text, '&' pads to
len_seq, '@' replaces out-of-alphabet characters, and reports are
lowercased. We therefore recreate a deterministic 71-char alphabet:
newline + space + the 32 ASCII punctuation/symbol characters + digits +
lowercase letters + tab = 1 + 1 + 32 + 10 + 26 + 1 = 71.
"""

import string

ALPHABET: str = (
    "\n" + "\t" + " " + string.punctuation + string.digits + string.ascii_lowercase
)

assert len(ALPHABET) == 71, len(ALPHABET)
assert "$" in ALPHABET and "&" in ALPHABET and "@" in ALPHABET

EOS_CHAR = "$"
PAD_CHAR = "&"
UNK_CHAR = "@"
