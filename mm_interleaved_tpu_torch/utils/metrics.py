"""Evaluation metrics.

Native ports of the metric stack the reference pulls from external packages
(SURVEY.md §2.5 / Lx): CIDEr-D + BLEU (pycocoevalcap wrappers in
`utils/coco_cap_score.py`), VQA accuracy (`utils/vqa_score.py` + the official
VQAEval forks), VisDial NDCG (`utils/visdial_metrics.py:93-169`), grounding
IoU acc@0.5 (`utils/grounding_score.py:6-60`) and segmentation mIoU
(`utils/segm_eval.py:9-70`).  FID lives in `fid.py` (needs InceptionV3
weights).  All pure numpy — nothing here touches a device.

The port's copy of `mm_interleaved_tpu/utils/metrics.py` (the port imports
nothing of the JAX package).  METEOR's stemmer is the port's
`utils.porter` (``nltk``'s default Porter stemmer, which the JAX copy
imports; the machine with the card has no ``nltk``).
"""

from __future__ import annotations

import re
from collections import Counter, defaultdict
from typing import Dict, List, Sequence

import numpy as np

from . import porter

# --------------------------------------------------------------------- #
# PTB tokenisation — the pycocoevalcap caption-scoring pipeline           #
# (reference `utils/coco_cap_score.py:7` scores through COCOEvalCap,      #
# whose PTBTokenizer runs the Stanford PTB tokenizer with ``-lowerCase``  #
# and then deletes the PUNCTUATIONS tokens below).  We reproduce the PTB  #
# rules — the Treebank sed-script transformations every PTB tokenizer     #
# implements: quote normalisation to ``/'', clitic splitting ('s 'll     #
# n't ...), bracket tokens (-LRB- ...), final-period splitting, intra-    #
# word hyphens kept — so caption scores are comparable to published       #
# pycocoevalcap numbers.                                                  #
# --------------------------------------------------------------------- #

# pycocoevalcap/tokenizer/ptbtokenizer.py PUNCTUATIONS — tokens deleted
# after tokenisation
_PTB_PUNCTUATIONS = {
    "''", "'", "``", "`", "-lrb-", "-rrb-", "-lcb-", "-rcb-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
}

_PTB_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]
_PTB_PUNCT_RULES = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # final-period split (keeps abbreviation-internal periods attached)
    (re.compile(r"([^\.])(\.)([\]\)}>\"\']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]
_PTB_BRACKETS = [
    (re.compile(r"\("), " -LRB- "), (re.compile(r"\)"), " -RRB- "),
    (re.compile(r"\["), " -LSB- "), (re.compile(r"\]"), " -RSB- "),
    (re.compile(r"\{"), " -LCB- "), (re.compile(r"\}"), " -RCB- "),
    (re.compile(r"--"), " -- "),
]
_PTB_ENDING_QUOTES = [
    (re.compile(r"\""), " '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]
_PTB_CONTRACTIONS = [
    re.compile(r"(?i)\b(can)(not)\b"),
    re.compile(r"(?i)\b(d)('ye)\b"),
    re.compile(r"(?i)\b(gim)(me)\b"),
    re.compile(r"(?i)\b(gon)(na)\b"),
    re.compile(r"(?i)\b(got)(ta)\b"),
    re.compile(r"(?i)\b(lem)(me)\b"),
    re.compile(r"(?i)\b(mor)('n)\b"),
    re.compile(r"(?i)\b(wan)(na)\s"),
    re.compile(r"(?i) ('t)(is)\b"),
    re.compile(r"(?i) ('t)(was)\b"),
]


def ptb_tokenize(s: str) -> List[str]:
    """Stanford-PTB-style tokens of ``s``, lowercased, with the
    pycocoevalcap PUNCTUATIONS tokens removed."""
    text = " " + s.strip() + " "
    for pat, sub in _PTB_STARTING_QUOTES:
        text = pat.sub(sub, text)
    for pat, sub in _PTB_PUNCT_RULES:
        text = pat.sub(sub, text)
    for pat, sub in _PTB_BRACKETS:
        text = pat.sub(sub, text)
    text = " " + text + " "
    for pat, sub in _PTB_ENDING_QUOTES:
        text = pat.sub(sub, text)
    for pat in _PTB_CONTRACTIONS:
        text = pat.sub(r" \1 \2 ", text)
    toks = text.lower().split()
    return [t for t in toks if t not in _PTB_PUNCTUATIONS]


def simple_tokenize(s: str) -> List[str]:
    """Alias retained for non-caption callers; caption metrics tokenize with
    the PTB pipeline above."""
    return ptb_tokenize(s)


def _ngrams(tokens: Sequence[str], n: int) -> Counter:
    return Counter(
        tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1)
    )


# --------------------------------------------------------------------- #
# BLEU (corpus-level, uniform weights, closest-ref brevity penalty)      #
# --------------------------------------------------------------------- #

def bleu(
    candidates: List[str], references: List[List[str]], max_n: int = 4
) -> float:
    """Corpus BLEU-4 with standard brevity penalty."""
    assert len(candidates) == len(references)
    clipped = np.zeros(max_n)
    totals = np.zeros(max_n)
    cand_len, ref_len = 0, 0
    for cand, refs in zip(candidates, references):
        ct = simple_tokenize(cand)
        rts = [simple_tokenize(r) for r in refs]
        cand_len += len(ct)
        ref_len += min((abs(len(r) - len(ct)), len(r)) for r in rts)[1]
        for n in range(1, max_n + 1):
            cn = _ngrams(ct, n)
            if not cn:
                continue
            max_ref = Counter()
            for rt in rts:
                rn = _ngrams(rt, n)
                for g, c in rn.items():
                    max_ref[g] = max(max_ref[g], c)
            totals[n - 1] += sum(cn.values())
            clipped[n - 1] += sum(
                min(c, max_ref.get(g, 0)) for g, c in cn.items()
            )
    # official bleu_scorer smoothing constants (tiny/small) keep zero-count
    # orders finite instead of zeroing the whole corpus score
    tiny, small = 1e-15, 1e-9
    precisions = (clipped + tiny) / (totals + small)
    log_p = np.mean(np.log(precisions))
    bp = 1.0 if cand_len > ref_len else np.exp(1 - ref_len / max(cand_len, 1))
    return float(bp * np.exp(log_p))


# --------------------------------------------------------------------- #
# ROUGE-L (COCOEvalCap's Rouge: LCS F-measure, beta = 1.2, max over      #
# references, mean over the corpus)                                     #
# --------------------------------------------------------------------- #

def _lcs_len(a: Sequence[str], b: Sequence[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b):
            cur.append(prev[j] + 1 if x == y else max(cur[j], prev[j + 1]))
        prev = cur
    return prev[-1]


def rouge_l(candidates: List[str], references: List[List[str]],
            beta: float = 1.2) -> float:
    assert len(candidates) == len(references)
    scores = []
    for cand, refs in zip(candidates, references):
        ct = ptb_tokenize(cand)
        prec, rec = [], []
        for r in refs:
            rt = ptb_tokenize(r)
            lcs = _lcs_len(ct, rt)
            prec.append(lcs / max(len(ct), 1))
            rec.append(lcs / max(len(rt), 1))
        p, r = max(prec, default=0.0), max(rec, default=0.0)
        if p != 0 and r != 0:
            scores.append(((1 + beta ** 2) * p * r) / (r + beta ** 2 * p))
        else:
            scores.append(0.0)
    return float(np.mean(scores)) if scores else 0.0


# --------------------------------------------------------------------- #
# METEOR (exact + stem modules)                                          #
#                                                                        #
# The reference scores captions with pycocoevalcap's METEOR 1.5 jar      #
# (utils/coco_cap_score.py:7), whose synonym/paraphrase stages need      #
# WordNet + paraphrase data files that cannot be shipped offline.  This  #
# is the exact+stem variant in nltk's parameterization (alpha=.9,        #
# beta=3, gamma=.5, greedy stage-wise alignment, max over references,    #
# mean over the corpus) — tests golden-diff it against nltk's own        #
# implementation with the synonym stage disabled.                        #
# --------------------------------------------------------------------- #

def _meteor_stage(h_left, r_left):
    """One greedy matching stage over enumerated (orig_idx, word) lists —
    hypothesis scanned END→START, each word paired with the LAST unused
    reference occurrence (nltk `_match_enums` semantics, so scores
    golden-diff against nltk exactly)."""
    from collections import defaultdict

    ref_positions = defaultdict(list)
    for j, (_, rw) in enumerate(r_left):
        ref_positions[rw].append(j)
    matches, used_h, used_r = [], set(), set()
    for i in range(len(h_left))[::-1]:
        positions = ref_positions.get(h_left[i][1])
        if positions:
            j = positions.pop()
            used_h.add(i)
            used_r.add(j)
            matches.append((h_left[i][0], r_left[j][0]))
    h_left = [p for i, p in enumerate(h_left) if i not in used_h]
    r_left = [p for j, p in enumerate(r_left) if j not in used_r]
    return matches, h_left, r_left


def _meteor_align(hyp: List[str], ref: List[str]):
    """Stage-wise unigram alignment (exact, then Porter stems): returns
    (hyp_idx, ref_idx) matches sorted by hypothesis index."""
    exact, h_left, r_left = _meteor_stage(
        list(enumerate(hyp)), list(enumerate(ref))
    )
    stem, _, _ = _meteor_stage(
        [(i, porter.stem(w)) for i, w in h_left],
        [(i, porter.stem(w)) for i, w in r_left],
    )
    return sorted(exact + stem)


def _meteor_chunks(matches) -> int:
    m = sorted(matches)
    if not m:
        return 0
    chunks = 1
    for (h0, r0), (h1, r1) in zip(m, m[1:]):
        if h1 != h0 + 1 or r1 != r0 + 1:
            chunks += 1
    return chunks


def meteor(candidates: List[str], references: List[List[str]],
           alpha: float = 0.9, beta: float = 3.0, gamma: float = 0.5
           ) -> float:
    assert len(candidates) == len(references)
    scores = []
    for cand, refs in zip(candidates, references):
        ct = ptb_tokenize(cand.lower())
        best = 0.0
        for r in refs:
            rt = ptb_tokenize(r.lower())
            matches = _meteor_align(ct, rt)
            m = len(matches)
            if m == 0 or not ct or not rt:
                continue
            p, rec = m / len(ct), m / len(rt)
            fmean = p * rec / (alpha * p + (1 - alpha) * rec)
            frag = _meteor_chunks(matches) / m
            best = max(best, fmean * (1.0 - gamma * frag ** beta))
        scores.append(best)
    return float(np.mean(scores)) if scores else 0.0


# --------------------------------------------------------------------- #
# CIDEr-D                                                                #
# --------------------------------------------------------------------- #

def cider_d(
    candidates: List[str], references: List[List[str]], max_n: int = 4,
    sigma: float = 6.0,
) -> float:
    """CIDEr-D: tf-idf weighted n-gram cosine similarity with length
    gaussian, averaged over n in 1..4, x10 (standard implementation)."""
    assert len(candidates) == len(references)
    M = len(candidates)
    cand_toks = [simple_tokenize(c) for c in candidates]
    ref_toks = [[simple_tokenize(r) for r in refs] for refs in references]

    # document frequency over reference sets
    df = [defaultdict(float) for _ in range(max_n)]
    for refs in ref_toks:
        for n in range(1, max_n + 1):
            seen = set()
            for rt in refs:
                seen |= set(_ngrams(rt, n).keys())
            for g in seen:
                df[n - 1][g] += 1.0
    log_m = np.log(max(M, 1))

    def tfidf_vec(tokens, n):
        cnt = _ngrams(tokens, n)
        vec = {}
        norm = 0.0
        for g, c in cnt.items():
            idf = log_m - np.log(max(df[n - 1].get(g, 0.0), 1.0))
            w = c * idf
            vec[g] = w
            norm += w * w
        return vec, np.sqrt(norm), len(tokens)

    scores = np.zeros(M)
    for i in range(M):
        score_n = np.zeros(max_n)
        for n in range(1, max_n + 1):
            cv, cnorm, clen = tfidf_vec(cand_toks[i], n)
            acc = 0.0
            for rt in ref_toks[i]:
                rv, rnorm, rlen = tfidf_vec(rt, n)
                # CIDEr-D: clipped dot product + length penalty
                dot = sum(min(w, rv.get(g, 0.0)) * rv.get(g, 0.0)
                          for g, w in cv.items())
                delta = clen - rlen
                if cnorm > 0 and rnorm > 0:
                    acc += (dot / (cnorm * rnorm)) * np.exp(
                        -(delta ** 2) / (2 * sigma ** 2)
                    )
            score_n[n - 1] = acc / max(len(ref_toks[i]), 1)
        scores[i] = score_n.mean() * 10.0
    return float(scores.mean())


# --------------------------------------------------------------------- #
# VQA accuracy — exact port of the official VQAEval normalisation        #
# (reference utils/vqav2_metrics_src/vqaEval.py:23-154, itself the       #
# GT-Vision-Lab reference scorer).  The full contraction table, the      #
# space-adjacency punctuation rule and the period regex are reproduced   #
# verbatim in behaviour — including the official quirks (uppercase-I     #
# contraction keys that never match lowercased text, the inverted       #
# "somebody'd" entry) so scores are bit-identical to published numbers.  #
# --------------------------------------------------------------------- #

_ARTICLES = {"a", "an", "the"}
_NUM_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
# Official contraction map (vqaEval.py:23-43). Kept byte-for-byte —
# including entries that can never fire after lowercasing ("Im", "Ive",
# "Id've", "I'dve") and the swapped "somebody'd": "somebodyd".
_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't",
    "couldve": "could've", "couldnt": "couldn't",
    "couldn'tve": "couldn't've", "couldnt've": "couldn't've",
    "didnt": "didn't", "doesnt": "doesn't", "dont": "don't",
    "hadnt": "hadn't", "hadnt've": "hadn't've", "hadn'tve": "hadn't've",
    "hasnt": "hasn't", "havent": "haven't", "hed": "he'd",
    "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's",
    "Id've": "I'd've", "I'dve": "I'd've", "Im": "I'm", "Ive": "I've",
    "isnt": "isn't", "itd": "it'd", "itd've": "it'd've",
    "it'dve": "it'd've", "itll": "it'll", "let's": "let's",
    "maam": "ma'am", "mightnt": "mightn't", "mightnt've": "mightn't've",
    "mightn'tve": "mightn't've", "mightve": "might've",
    "mustnt": "mustn't", "mustve": "must've", "neednt": "needn't",
    "notve": "not've", "oclock": "o'clock", "oughtnt": "oughtn't",
    "ow's'at": "'ow's'at", "'ows'at": "'ow's'at", "'ow'sat": "'ow's'at",
    "shant": "shan't", "shed've": "she'd've", "she'dve": "she'd've",
    "she's": "she's", "shouldve": "should've", "shouldnt": "shouldn't",
    "shouldnt've": "shouldn't've", "shouldn'tve": "shouldn't've",
    "somebody'd": "somebodyd", "somebodyd've": "somebody'd've",
    "somebody'dve": "somebody'd've", "somebodyll": "somebody'll",
    "somebodys": "somebody's", "someoned": "someone'd",
    "someoned've": "someone'd've", "someone'dve": "someone'd've",
    "someonell": "someone'll", "someones": "someone's",
    "somethingd": "something'd", "somethingd've": "something'd've",
    "something'dve": "something'd've", "somethingll": "something'll",
    "thats": "that's", "thered": "there'd", "thered've": "there'd've",
    "there'dve": "there'd've", "therere": "there're", "theres": "there's",
    "theyd": "they'd", "theyd've": "they'd've", "they'dve": "they'd've",
    "theyll": "they'll", "theyre": "they're", "theyve": "they've",
    "twas": "'twas", "wasnt": "wasn't", "wed've": "we'd've",
    "we'dve": "we'd've", "weve": "we've", "werent": "weren't",
    "whatll": "what'll", "whatre": "what're", "whats": "what's",
    "whatve": "what've", "whens": "when's", "whered": "where'd",
    "wheres": "where's", "whereve": "where've", "whod": "who'd",
    "whod've": "who'd've", "who'dve": "who'd've", "wholl": "who'll",
    "whos": "who's", "whove": "who've", "whyll": "why'll",
    "whyre": "why're", "whys": "why's", "wont": "won't",
    "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}
_VQA_PUNCT = [";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+",
              "\\", "_", "-", ">", "<", "@", "`", ",", "?", "!"]
# official regexes (vqaEval.py:63-64; the period pattern keeps decimals)
_PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
_COMMA_STRIP = re.compile(r"(\d)(\,)(\d)")


def _vqa_process_punctuation(text: str) -> str:
    """vqaEval.processPunctuation (:129-139): a punctuation char adjacent to
    a space (or any text with a digit,digit comma) is deleted; otherwise it
    becomes a space. Then strip non-decimal periods."""
    out = text
    for p in _VQA_PUNCT:
        if (p + " " in text or " " + p in text) or (
            _COMMA_STRIP.search(text) is not None
        ):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    return _PERIOD_STRIP.sub("", out)


def _vqa_process_digit_article(text: str) -> str:
    """vqaEval.processDigitArticle (:141-154)."""
    words = []
    for w in text.lower().split():
        w = _NUM_MAP.get(w, w)
        if w not in _ARTICLES:
            words.append(w)
    return " ".join(_CONTRACTIONS.get(w, w) for w in words)


def normalize_vqa_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return _vqa_process_digit_article(_vqa_process_punctuation(ans))


def vqa_accuracy(pred: str, gt_answers: Sequence[str]) -> float:
    """Official VQA accuracy (vqaEval.py:88-117): leave-one-out over all
    (possibly duplicated) gt answers, min(#matches/3, 1) averaged.

    Normalisation is applied only when the gt answers are not all identical
    — faithful to the official `len(set(gtAnswers)) > 1` gate (:100-105)."""
    clean = lambda s: s.replace("\n", " ").replace("\t", " ").strip()
    pred = clean(pred)
    gts = [clean(a) for a in gt_answers]
    if len(set(gts)) > 1:
        pred = _vqa_process_digit_article(_vqa_process_punctuation(pred))
        gts = [
            _vqa_process_digit_article(_vqa_process_punctuation(a))
            for a in gts
        ]
    if len(gts) == 1:  # non-VQAv2 datasets with a single gt answer
        return float(pred == gts[0])
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        matches = sum(1 for a in others if a == pred)
        accs.append(min(1.0, matches / 3.0))
    return float(np.mean(accs)) if accs else 0.0


def extract_vqa_answer(text: str) -> str:
    """Answer post-processing (reference utils/vqa_score.py:9-33): take the
    first sentence/segment, strip common prefixes."""
    text = text.strip().lower()
    for stop in (".", ",", "\n"):
        if stop in text:
            text = text.split(stop)[0]
    for prefix in ("the answer is", "answer:", "it is", "it's"):
        if text.startswith(prefix):
            text = text[len(prefix):]
    return text.strip()


# --------------------------------------------------------------------- #
# VisDial NDCG (visdial_metrics.py:21-169)                               #
# --------------------------------------------------------------------- #

def scores_to_ranks(scores: np.ndarray) -> np.ndarray:
    """[..., n_options] scores -> 1-indexed ranks."""
    order = np.argsort(-scores, axis=-1)
    ranks = np.empty_like(order)
    idx = np.arange(scores.shape[-1])
    np.put_along_axis(ranks, order, idx + 1, axis=-1)
    return ranks


def ndcg(scores: np.ndarray, relevance: np.ndarray) -> float:
    """Mean NDCG@k where k = #relevant options per row (official VisDial)."""
    total = 0.0
    n = scores.shape[0]
    for i in range(n):
        rel = relevance[i]
        k = int((rel > 0).sum())
        if k == 0:
            continue
        order = np.argsort(-scores[i], kind="stable")
        gains = rel[order][:k]
        discounts = 1.0 / np.log2(np.arange(2, k + 2))
        dcg = float((gains * discounts).sum())
        ideal = np.sort(rel)[::-1][:k]
        idcg = float((ideal * discounts).sum())
        total += dcg / max(idcg, 1e-12)
    return total / max(n, 1)


# --------------------------------------------------------------------- #
# grounding + segmentation                                               #
# --------------------------------------------------------------------- #

def box_iou(a: Sequence[float], b: Sequence[float]) -> float:
    ax1, ay1, ax2, ay2 = a
    bx1, by1, bx2, by2 = b
    ix1, iy1 = max(ax1, bx1), max(ay1, by1)
    ix2, iy2 = min(ax2, bx2), min(ay2, by2)
    iw, ih = max(0.0, ix2 - ix1), max(0.0, iy2 - iy1)
    inter = iw * ih
    union = ((ax2 - ax1) * (ay2 - ay1) + (bx2 - bx1) * (by2 - by1) - inter)
    return inter / max(union, 1e-12)


def grounding_accuracy(pred_boxes, gt_boxes, thresh: float = 0.5) -> float:
    """acc@IoU>=0.5 (reference grounding_score.py:41)."""
    hits = [box_iou(p, g) >= thresh for p, g in zip(pred_boxes, gt_boxes)]
    return float(np.mean(hits)) if hits else 0.0


def intersection_and_union(pred: np.ndarray, label: np.ndarray,
                           num_classes: int):
    """Exact port of the reference's ADE20k accumulator
    (segm_eval.py:25-45): classes are 1-indexed, label 0 = unlabeled
    (predictions there are not penalised). Returns per-class
    (intersection, union) arrays of length num_classes."""
    pred = np.asarray(pred).copy()
    label = np.asarray(label)
    pred = pred * (label > 0)
    inter = pred * (pred == label)
    area_inter, _ = np.histogram(inter, bins=num_classes,
                                 range=(1, num_classes))
    area_pred, _ = np.histogram(pred, bins=num_classes,
                                range=(1, num_classes))
    area_label, _ = np.histogram(label, bins=num_classes,
                                 range=(1, num_classes))
    return area_inter, area_pred + area_label - area_inter


def miou_from_maps(preds, labels, num_classes: int = 150) -> float:
    """Reference `calculate_miou_given_paths` math (segm_eval.py:48-66):
    accumulate intersection/union over the dataset, average over all
    classes (zero-union classes contribute 0)."""
    all_inter = np.zeros(num_classes, np.float64)
    all_union = np.zeros(num_classes, np.float64)
    for pred, label in zip(preds, labels):
        inter, union = intersection_and_union(pred, label, num_classes)
        all_inter += inter
        all_union += union
    return float((all_inter / (all_union + 1e-10)).mean())


def mean_iou(pred: np.ndarray, gt: np.ndarray, num_classes: int,
             ignore_index: int = 255) -> float:
    """Per-class IoU averaged (reference segm_eval.py:47)."""
    valid = gt != ignore_index
    ious = []
    for c in range(num_classes):
        p = (pred == c) & valid
        g = (gt == c) & valid
        union = (p | g).sum()
        if union == 0:
            continue
        ious.append((p & g).sum() / union)
    return float(np.mean(ious)) if ious else 0.0


def parse_box_string(s: str) -> List[List[float]]:
    """Parse '<box>(x1,y1)(x2,y2)</box>' grounding output strings
    (reference collator.py:724-990 emits 3-digit [0,1]x1000 coords)."""
    out = []
    for m in re.finditer(
        r"\((\d+),\s*(\d+)\)\s*\((\d+),\s*(\d+)\)", s
    ):
        x1, y1, x2, y2 = (int(m.group(i)) / 1000.0 for i in range(1, 5))
        out.append([x1, y1, x2, y2])
    return out
