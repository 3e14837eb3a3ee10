"""The Porter stemmer (Porter, "An algorithm for suffix stripping", 1980)
with the extensions NLTK applies by default (``PorterStemmer()``'s
``NLTK_EXTENSIONS`` mode), for the METEOR metric of `utils.metrics`.

The JAX package's metrics take the stemmer from ``nltk``; the machine with
the card has no ``nltk``, so the port carries this implementation, held
to ``nltk``'s on a vocabulary by tests/test_torch_eval.py.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

VOWELS = frozenset("aeiou")

# NLTK's irregular forms: each form stems to its key
IRREGULAR = {form: key for key, forms in {
    "sky": ["sky", "skies"], "die": ["dying"], "lie": ["lying"],
    "tie": ["tying"], "news": ["news"], "inning": ["innings", "inning"],
    "outing": ["outings", "outing"], "canning": ["cannings", "canning"],
    "howe": ["howe"], "proceed": ["proceed"], "exceed": ["exceed"],
    "succeed": ["succeed"],
}.items() for form in forms}

Rule = Tuple[str, str, Optional[Callable[[str], bool]]]


def is_consonant(word: str, i: int) -> bool:
    """A letter other than a vowel, and other than a y after a consonant
    (a run of y's alternates)."""
    if word[i] in VOWELS:
        return False
    if word[i] != "y":
        return True
    negate = False
    while i > 0 and word[i] == "y":
        negate = not negate
        i -= 1
    return (word[i] not in VOWELS) != negate


def measure(stem: str) -> int:
    """m of ``[C](VC){m}[V]``: the number of vowel-consonant changes."""
    cv = "".join("c" if is_consonant(stem, i) else "v"
                 for i in range(len(stem)))
    return cv.count("vc")


def positive(stem: str) -> bool:
    return measure(stem) > 0


def contains_vowel(stem: str) -> bool:
    return any(not is_consonant(stem, i) for i in range(len(stem)))


def ends_double_consonant(word: str) -> bool:
    return (len(word) >= 2 and word[-1] == word[-2]
            and is_consonant(word, len(word) - 1))


def ends_cvc(word: str) -> bool:
    """``*o``: consonant, vowel, consonant other than w, x or y; or (NLTK)
    a two-letter vowel, consonant word."""
    n = len(word)
    if n >= 3 and is_consonant(word, n - 3) and not is_consonant(word, n - 2) \
            and is_consonant(word, n - 1) and word[-1] not in "wxy":
        return True
    return n == 2 and not is_consonant(word, 0) and is_consonant(word, 1)


def apply_rules(word: str, rules: List[Rule]) -> str:
    """The first rule whose suffix the word has decides: its replacement
    when its condition holds on the stem, else the word unchanged.  The
    suffix ``"*d"`` matches a double consonant (both letters removed)."""
    for suffix, replacement, condition in rules:
        if suffix == "*d":
            if not ends_double_consonant(word):
                continue
            stem = word[:-2]
        elif word.endswith(suffix):
            stem = word[:len(word) - len(suffix)]
        else:
            continue
        return stem + replacement if condition is None or condition(stem) \
            else word
    return word


def step1a(word: str) -> str:
    if word.endswith("ies") and len(word) == 4:
        return word[:-3] + "ie"
    return apply_rules(word, [("sses", "ss", None), ("ies", "i", None),
                              ("ss", "ss", None), ("s", "", None)])


def step1b(word: str) -> str:
    if word.endswith("ied"):
        return word[:-3] + ("ie" if len(word) == 4 else "i")
    if word.endswith("eed"):
        stem = word[:-3]
        return stem + "ee" if measure(stem) > 0 else word
    for suffix in ("ed", "ing"):
        if word.endswith(suffix) and contains_vowel(word[:-len(suffix)]):
            stem = word[:-len(suffix)]
            break
    else:
        return word
    return apply_rules(stem, [
        ("at", "ate", None), ("bl", "ble", None), ("iz", "ize", None),
        ("*d", stem[-1], lambda s: stem[-1] not in "lsz"),
        ("", "e", lambda s: measure(s) == 1 and ends_cvc(s)),
    ])


def step1c(word: str) -> str:
    return apply_rules(word, [(
        "y", "i", lambda s: len(s) > 1 and is_consonant(s, len(s) - 1))])


STEP2 = [("ational", "ate"), ("tional", "tion"), ("enci", "ence"),
         ("anci", "ance"), ("izer", "ize"), ("bli", "ble"), ("alli", "al"),
         ("entli", "ent"), ("eli", "e"), ("ousli", "ous"),
         ("ization", "ize"), ("ation", "ate"), ("ator", "ate"),
         ("alism", "al"), ("iveness", "ive"), ("fulness", "ful"),
         ("ousness", "ous"), ("aliti", "al"), ("iviti", "ive"),
         ("biliti", "ble"), ("fulli", "ful")]


def step2(word: str) -> str:
    if word.endswith("alli") and positive(word[:-4]):
        return step2(word[:-4] + "al")
    rules: List[Rule] = [(s, r, positive) for s, r in STEP2]
    rules.append(("logi", "log", lambda s: positive(word[:-3])))
    return apply_rules(word, rules)


def step3(word: str) -> str:
    return apply_rules(word, [(s, r, positive) for s, r in (
        ("icate", "ic"), ("ative", ""), ("alize", "al"), ("iciti", "ic"),
        ("ical", "ic"), ("ful", ""), ("ness", ""))])


def step4(word: str) -> str:
    def gt1(s):
        return measure(s) > 1

    rules: List[Rule] = [(s, "", gt1) for s in (
        "al", "ance", "ence", "er", "ic", "able", "ible", "ant", "ement",
        "ment", "ent")]
    rules.append(("ion", "", lambda s: gt1(s) and s[-1] in "st"))
    rules += [(s, "", gt1) for s in ("ou", "ism", "ate", "iti", "ous", "ive",
                                     "ize")]
    return apply_rules(word, rules)


def step5a(word: str) -> str:
    if word.endswith("e"):
        stem = word[:-1]
        m = measure(stem)
        if m > 1 or (m == 1 and not ends_cvc(stem)):
            return stem
    return word


def step5b(word: str) -> str:
    return apply_rules(word, [("ll", "l", lambda s: measure(word[:-1]) > 1)])


def stem(word: str) -> str:
    """``word``'s stem, lower-cased, as ``nltk``'s default `PorterStemmer`
    gives it."""
    s = word.lower()
    if s in IRREGULAR:
        return IRREGULAR[s]
    if len(word) <= 2:
        return s
    for step in (step1a, step1b, step1c, step2, step3, step4, step5a,
                 step5b):
        s = step(s)
    return s
