"""Symbol inventory for text input (a copy of the reference's 150-symbol table).

pad `_` (id 0), eos `~` (id 1), `<unk>` (id 2), 52 ASCII letters, 11 punctuation
characters including space, and 84 ARPAbet symbols prefixed with `@`.
"""

PAD = "_"
EOS = "~"
UNK = "<unk>"

_characters = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz!'(),-.:;? "

ARPABET = [
    "AA", "AA0", "AA1", "AA2", "AE", "AE0", "AE1", "AE2", "AH", "AH0", "AH1", "AH2",
    "AO", "AO0", "AO1", "AO2", "AW", "AW0", "AW1", "AW2", "AY", "AY0", "AY1", "AY2",
    "B", "CH", "D", "DH", "EH", "EH0", "EH1", "EH2", "ER", "ER0", "ER1", "ER2", "EY",
    "EY0", "EY1", "EY2", "F", "G", "HH", "IH", "IH0", "IH1", "IH2", "IY", "IY0", "IY1",
    "IY2", "JH", "K", "L", "M", "N", "NG", "OW", "OW0", "OW1", "OW2", "OY", "OY0",
    "OY1", "OY2", "P", "R", "S", "SH", "T", "TH", "UH", "UH0", "UH1", "UH2", "UW",
    "UW0", "UW1", "UW2", "V", "W", "Y", "Z", "ZH",
]

symbols = [PAD, EOS, UNK] + list(_characters) + ["@" + s for s in ARPABET]

SYMBOL_TO_ID = {s: i for i, s in enumerate(symbols)}
