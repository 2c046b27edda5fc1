"""Symbol inventory for text input (a copy of the reference's 150-symbol table).

pad `_` (id 0), eos `~` (id 1), `<unk>` (id 2), 52 ASCII letters, 11 punctuation
characters including space, and the 84 ARPAbet symbols of `cmudict.valid_symbols`
prefixed with `@`, so they never collide with uppercase letters.
"""

from matcha_tpu_torch.text.cmudict import valid_symbols

PAD = "_"
EOS = "~"
UNK = "<unk>"

_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'(),-.:;? "

_arpabet = ["@" + s for s in valid_symbols]

symbols = [PAD, EOS, UNK] + list(_characters) + _arpabet

SYMBOL_TO_ID = {s: i for i, s in enumerate(symbols)}
ID_TO_SYMBOL = {i: s for i, s in enumerate(symbols)}

PAD_ID = SYMBOL_TO_ID[PAD]
EOS_ID = SYMBOL_TO_ID[EOS]
UNK_ID = SYMBOL_TO_ID[UNK]
