"""Text-frontend walkthrough on the PyTorch port: cleaners, CMUdict, tokenizers.

The port's counterpart of `examples/test_text.ipynb`: `english_cleaners` on
a sentence with a title, numbers and money; `CMUDict.lookup` of two words
(the dictionary ships with the package); `text_to_sequence` with an
`{ARPAbet}` segment and EOS, and its round trip through `sequence_to_text`;
`simple_text_to_sequence` (what inference calls) and `train_text_to_sequence`
(what the training data path calls). Runs on the CPU, where the text
frontend runs in the port; prints each result.

    python examples/walkthrough_text_torch.py
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))  # the repository's package

# the notebook's inputs
CLEANER_TEXT = "Dr. Smith bought 2 apples for $1.50 in 1999!"
LOOKUP_WORDS = ("hello", "read")
ARPABET_TEXT = "Turn left on {HH AW1 S S T AH0 N} Street."
SIMPLE_TEXT = "Hello world"


def main(argv=None) -> dict:
    argparse.ArgumentParser(description=__doc__.splitlines()[0]).parse_args(argv)
    from matcha_tpu_torch.text import (english_cleaners, sequence_to_text,
                                       simple_text_to_sequence, text_to_sequence,
                                       train_text_to_sequence)
    from matcha_tpu_torch.text.cmudict import CMUDict

    cmu = CMUDict()
    full = text_to_sequence(ARPABET_TEXT, ["english_cleaners"])
    res = {"cleaned": english_cleaners(CLEANER_TEXT),
           "lookup": {w: cmu.lookup(w) for w in LOOKUP_WORDS},
           "full": full, "round_trip": sequence_to_text(full),
           "simple": simple_text_to_sequence(SIMPLE_TEXT),
           "train": train_text_to_sequence(SIMPLE_TEXT)}
    print("english_cleaners:", res["cleaned"])
    for word, prons in res["lookup"].items():
        print(f"cmudict {word!r}:", prons)
    print("full keithito (+EOS):", res["full"])
    print("round trip:", res["round_trip"])
    print("simplified (inference scripts):", res["simple"])
    print("training char-level:", res["train"])
    return res


if __name__ == "__main__":
    main()
