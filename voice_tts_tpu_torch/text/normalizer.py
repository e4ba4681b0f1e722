"""Text normalization (zh + en) without WeTextProcessing.

The reference delegates Chinese/English TN to compiled OpenFst grammars
(`utils/front.py:100-111`, `tagger_cache/*.fst`).  Those artifacts and their
CPython bindings are unavailable here, so this module implements the
normalization rules natively: punctuation canonicalization (the reference's
`char_rep_map`), pinyin-tone and person-name preservation (same regex
machinery as `front.py:62-76,191-228`), plus rule-based verbalization across
the WeTextProcessing category list: numbers (incl. 万/亿 suffixes, thousands
separators, negatives), dates (年/月/日//-/. variants, decades, cohorts),
times (+ ranges), scores, phones/landlines/ID numbers/license plates,
fractions, percent/permille, currency (¥ $ € £ ₩ + 万/亿 amounts), measure
words (km..kcal, areas/volumes/rates), temperatures (℃/°F/°), numeric
ranges, arithmetic, IPs/dotted versions; and number spelling for en.
Coverage is validated by the 210-case golden corpus
(`tests/data/tn_corpus_zh.tsv`) plus the reference smoke corpus
(`front.py:439-490`) — still narrower than the 2 MB compiled FST grammar on
long-tail idioms, but no longer a smoke-test subset.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# punctuation canonicalization (reference `front.py:15-55`)
# ---------------------------------------------------------------------------

CHAR_REP_MAP = {
    "：": ",", "；": ",", ";": ",", "，": ",", "。": ".", "！": "!", "？": "?",
    "\n": " ", "·": "-", "、": ",", "...": "…", ",,,": "…", "，，，": "…",
    "……": "…", "“": "'", "”": "'", '"': "'", "‘": "'", "’": "'", "（": "'",
    "）": "'", "(": "'", ")": "'", "《": "'", "》": "'", "【": "'", "】": "'",
    "[": "'", "]": "'", "—": "-", "～": "-", "~": "-", "「": "'", "」": "'",
    ":": ",",
}
ZH_CHAR_REP_MAP = {"$": ".", **CHAR_REP_MAP}

PINYIN_TONE_PATTERN = (
    r"(?<![a-z])((?:[bpmfdtnlgkhjqxzcsryw]|[zcs]h)?"
    r"(?:[aeiouüv]|[ae]i|u[aio]|ao|ou|i[aue]|[uüv]e|[uvü]ang?|uai|[aeiuv]n"
    r"|[aeio]ng|ia[no]|i[ao]ng)|ng|er)([1-5])"
)
NAME_PATTERN = r"[一-鿿]+(?:[-·—][一-鿿]+){1,2}"
ENGLISH_CONTRACTION_PATTERN = r"(what|where|who|which|how|t?here|it|s?he|that|this)'s"

# ---------------------------------------------------------------------------
# number verbalization
# ---------------------------------------------------------------------------

_ZH_DIGITS = "零一二三四五六七八九"
_ZH_UNITS = ["", "十", "百", "千"]
_ZH_GROUPS = ["", "万", "亿", "万亿"]


def zh_read_digits(digits: str) -> str:
    """Digit-by-digit reading: '135' -> '一三五'."""
    return "".join(_ZH_DIGITS[int(d)] for d in digits if d.isdigit())


def zh_read_integer(num: int) -> str:
    """Standard Chinese integer reading: 10250 -> 一万零二百五十.

    Uses the native C++ core (`native/tn_core.cpp`) when built; this Python
    path is the reference implementation and fallback."""
    from voice_tts_tpu_torch.text import native_tn
    native = native_tn.zh_read_integer(num)
    if native is not None:
        return native
    if num == 0:
        return "零"
    if num < 0:
        return "负" + zh_read_integer(-num)
    groups = []
    while num > 0:
        groups.append(num % 10000)
        num //= 10000
    parts: List[str] = []
    for gi in range(len(groups) - 1, -1, -1):
        g = groups[gi]
        if g == 0:
            continue
        text = ""
        zero_pending = False
        for pos in range(3, -1, -1):
            d = (g // 10 ** pos) % 10
            if d == 0:
                if text:
                    zero_pending = True
                continue
            if zero_pending:
                text += "零"
                zero_pending = False
            if not (pos == 1 and d == 1 and not text and gi == len(groups) - 1
                    and g < 20):
                text += _ZH_DIGITS[d]
            text += _ZH_UNITS[pos]
        # linking 零 between groups: needed when the group has leading zeros
        # (10000200 -> 一千万零二百) OR a whole higher group was skipped
        # (100000001 -> 一亿零一)
        if parts and (g < 1000 or groups[gi + 1] == 0):
            text = "零" + text
        parts.append(text + _ZH_GROUPS[gi])
    return "".join(parts)


def zh_read_number(token: str) -> str:
    """Read a decimal number string in Chinese."""
    neg = token.startswith("-")
    token = token.lstrip("+-").replace(",", "")
    if "." in token:
        int_part, frac = token.split(".", 1)
        text = zh_read_integer(int(int_part or "0")) + "点" + zh_read_digits(frac)
    else:
        text = zh_read_integer(int(token))
    return ("负" if neg else "") + text


_EN_ONES = ["zero", "one", "two", "three", "four", "five", "six", "seven",
            "eight", "nine", "ten", "eleven", "twelve", "thirteen", "fourteen",
            "fifteen", "sixteen", "seventeen", "eighteen", "nineteen"]
_EN_TENS = ["", "", "twenty", "thirty", "forty", "fifty", "sixty", "seventy",
            "eighty", "ninety"]


def en_read_integer(num: int) -> str:
    from voice_tts_tpu_torch.text import native_tn
    native = native_tn.en_read_integer(num)
    if native is not None:
        return native
    if num < 0:
        return "minus " + en_read_integer(-num)
    if num < 20:
        return _EN_ONES[num]
    if num < 100:
        tens, ones = divmod(num, 10)
        return _EN_TENS[tens] + ("-" + _EN_ONES[ones] if ones else "")
    for value, name in [(10 ** 9, "billion"), (10 ** 6, "million"),
                        (10 ** 3, "thousand"), (100, "hundred")]:
        if num >= value:
            head = en_read_integer(num // value) + " " + name
            rest = num % value
            return head + (" " + en_read_integer(rest) if rest else "")
    return str(num)


def en_read_number(token: str) -> str:
    token = token.replace(",", "")
    if "." in token:
        int_part, frac = token.split(".", 1)
        digits = " ".join(_EN_ONES[int(d)] for d in frac if d.isdigit())
        return en_read_integer(int(int_part or "0")) + " point " + digits
    return en_read_integer(int(token))


# ---------------------------------------------------------------------------
# zh rules
# ---------------------------------------------------------------------------

class _Groups:
    """Adapter presenting (g1, g2, g3) as a match-like .group(i) — lets the
    time-range rule reuse `time_hm` for the second endpoint's groups 4-6."""

    def __init__(self, *groups):
        self._g = groups

    def group(self, i):
        return self._g[i - 1]


def _zh_verbalize(text: str) -> str:
    # dates: 2025年01月11日 / 2025/1/2 / 2025-01-11 / 2025.1.11 / 1月11日
    def date_ymd(m):
        y, mo, d = m.group(1), int(m.group(2)), int(m.group(3))
        return (zh_read_digits(y) + "年" + zh_read_integer(mo) + "月"
                + zh_read_integer(d) + "日")

    # date spans: 3月5日-8日 / 2024年3月5日~8日 — rewrite the dash to 至 so
    # the endpoint day reads as a date, not a stray number (WeTextProcessing
    # date-range tagger)
    text = re.sub(r"([日号])[-~—](?=\d{1,2}[日号])", r"\g<1>至", text)
    text = re.sub(r"(\d{4})年(\d{1,2})月(\d{1,2})[日号]", date_ymd, text)
    text = re.sub(r"(\d{4})[/.-](\d{1,2})[/.-](\d{1,2})(?!\d)",
                  lambda m: date_ymd(m), text)
    text = re.sub(r"(\d{4})[-~](\d{4})年",
                  lambda m: zh_read_digits(m.group(1)) + "到"
                  + zh_read_digits(m.group(2)) + "年", text)
    text = re.sub(r"(\d{4})年",
                  lambda m: zh_read_digits(m.group(1)) + "年", text)
    # 2-digit years read digit-wise when they are clearly years: followed
    # by a month (09年3月 -> 零九年三月) or leading-zero (05年 -> 零五年)
    text = re.sub(r"(?<![\d.])(\d{2})年(?=\d{1,2}月)",
                  lambda m: zh_read_digits(m.group(1)) + "年", text)
    text = re.sub(r"(?<![\d.])(0\d)年",
                  lambda m: zh_read_digits(m.group(1)) + "年", text)
    # month-day without a year (WeTextProcessing date class)
    text = re.sub(r"(?<![\d.])(\d{1,2})月(\d{1,2})([日号])",
                  lambda m: zh_read_integer(int(m.group(1))) + "月"
                  + zh_read_integer(int(m.group(2))) + m.group(3), text)
    # cohorts digit-wise (90后 -> 九零后); decades cardinal (90年代 ->
    # 九十年代 — the standard mainland reading, 二十世纪九十年代)
    text = re.sub(r"(?<!\d)(\d0)后(?!\d)",
                  lambda m: zh_read_digits(m.group(1)) + "后", text)
    text = re.sub(r"(?<!\d)(\d0)年代(?!\d)",
                  lambda m: zh_read_integer(int(m.group(1))) + "年代", text)

    # IP addresses / multi-dot versions BEFORE times and plain numbers:
    # 192.168.1.1 -> digit-wise with 点 (WeTextProcessing digit class)
    def dotted(m):
        parts = m.group(0).split(".")
        return "点".join(zh_read_digits(p) for p in parts)

    text = re.sub(r"(?<![\d.])\d{1,3}(?:\.\d{1,3}){3}(?![\d.])", dotted, text)
    text = re.sub(r"(?<![\d.])\d+(?:\.\d+){2,}(?![\d.])", dotted, text)

    # times: 20:00 / 8:30 / 8:30:15 (minutes must be a valid 00-59 pair;
    # other colon pairs read as scores below)
    def time_hm(m):
        h, mi = int(m.group(1)), int(m.group(2))
        out = zh_read_integer(h) + "点"
        if mi:
            # leading zero is read: 8:05 -> 八点零五分 (WeTextProcessing)
            out += ("零" if mi < 10 else "") + zh_read_integer(mi) + "分"
        if m.group(3):
            s = int(m.group(3))
            out += ("零" if 0 < s < 10 else "") + zh_read_integer(s) + "秒"
        return out

    time_pat = r"([01]?\d|2[0-3]):([0-5]\d)(?::([0-5]\d))?"
    # time ranges first so the dash reads 到: 8:00-9:30
    text = re.sub(r"(?<![\d:])" + time_pat + r"[-~]" + time_pat + r"(?![\d:])",
                  lambda m: time_hm(m) + "到" + time_hm(
                      _Groups(m.group(4), m.group(5), m.group(6))), text)
    text = re.sub(r"(?<![\d:])" + time_pat + r"(?![\d:])", time_hm, text)

    # scores: 2:1 / 3:0 (a colon pair that is not a valid clock time)
    text = re.sub(r"(?<![\d:])(\d{1,3}):(\d{1,3})(?![\d:])",
                  lambda m: zh_read_integer(int(m.group(1))) + "比"
                  + zh_read_integer(int(m.group(2))), text)

    # phone-like digit runs with separators: 135-4567-8900 (1 reads 幺)
    def phone(m):
        return zh_read_digits(re.sub(r"\D", "", m.group(0))).replace("一", "幺")

    text = re.sub(r"\d{3,4}-\d{3,4}-\d{3,4}", phone, text)
    # service/hotline numbers after a dialing cue read digit-wise with 幺:
    # 拨打12306 -> 拨打幺二三零六 (WeTextProcessing telephone tagger)
    text = re.sub(r"(拨打|致电|热线|客服电话|报警电话|服务电话)\s*(\d{3,8})"
                  r"(?!\d)",
                  lambda m: m.group(1)
                  + zh_read_digits(m.group(2)).replace("一", "幺"), text)
    text = re.sub(r"(?<![\d-])0\d{2,3}-\d{7,8}(?![\d-])", phone, text)  # landline
    text = re.sub(r"(?<!\d)1[3-9]\d{9}(?!\d)", phone, text)  # bare mobile no.
    # 18-digit ID numbers (optional trailing X): digit-wise, 1 reads 幺
    text = re.sub(r"(?<!\d)(\d{17})([0-9Xx])(?![\dXx])",
                  lambda m: phone(m) + ("X" if m.group(2) in "Xx" else ""),
                  text)
    # any very long bare digit run (>= 10): digit-wise like the reference FST
    text = re.sub(r"(?<!\d)\d{10,}(?!\d)",
                  lambda m: zh_read_digits(m.group(0)), text)

    # fractions: 3/4 -> 四分之三
    text = re.sub(r"(?<![\d/])(\d{1,4})/(\d{1,4})(?![\d/])",
                  lambda m: zh_read_integer(int(m.group(2))) + "分之"
                  + zh_read_integer(int(m.group(1))), text)

    # temperature: -5°C / 36.5℃ (negative reads 零下)
    def temp(m):
        sign = "零下" if m.group(1) else ""
        return sign + zh_read_number(m.group(2)) + "摄氏度"

    text = re.sub(r"(-|零下)?(\d+(?:\.\d+)?)\s*(?:°C|℃)", temp, text)

    # percent ranges: 10%~20% / 10~20%  -> 百分之十到百分之二十
    text = re.sub(r"(\d+(?:\.\d+)?)%?[-~](\d+(?:\.\d+)?)%",
                  lambda m: "百分之" + zh_read_number(m.group(1)) + "到百分之"
                  + zh_read_number(m.group(2)), text)

    # numeric ranges: 3-5个 / 10~20天 (after phone rules so separator-digit
    # runs of phone shape are already consumed)
    def rng(m):
        a, b = m.group(1), m.group(2)
        if "." in a or "." in b:
            return zh_read_number(a) + "到" + zh_read_number(b)
        return zh_read_integer(int(a)) + "到" + zh_read_integer(int(b))

    text = re.sub(r"(?<![\d.-])(\d{1,4}(?:\.\d+)?)[-~](\d{1,4}(?:\.\d+)?)"
                  r"(?![\d.-])", rng, text)
    # negative ranges: -5~-3 -> 负五到负三 (both endpoints signed)
    text = re.sub(r"(?<![\d.\w-])-(\d{1,4}(?:\.\d+)?)[-~]-"
                  r"(\d{1,4}(?:\.\d+)?)(?![\d.-])",
                  lambda m: "负" + zh_read_number(m.group(1)) + "到负"
                  + zh_read_number(m.group(2)), text)

    # measure units (WeTextProcessing measure class, common subset)
    units = {"km": "千米", "kg": "千克", "cm": "厘米", "mm": "毫米",
             "ml": "毫升", "mL": "毫升", "mg": "毫克", "m²": "平方米",
             "㎡": "平方米", "m³": "立方米", "km²": "平方千米",
             "cm²": "平方厘米", "km/h": "千米每小时", "m/s": "米每秒",
             "GHz": "吉赫兹", "MHz": "兆赫兹", "kHz": "千赫兹", "Hz": "赫兹",
             "TB": "太字节", "GB": "吉字节", "MB": "兆字节", "KB": "千字节",
             "kW": "千瓦", "kWh": "千瓦时", "kg/m³": "千克每立方米",
             "μm": "微米", "µm": "微米", "nm": "纳米", "kV": "千伏",
             "mV": "毫伏", "mA": "毫安", "kcal": "千卡", "kJ": "千焦",
             "°F": "华氏度", "℉": "华氏度", "°": "度",
             "L": "升", "t": "吨", "W": "瓦", "V": "伏", "A": "安",
             # lowercase g only: 3.2g -> 三点二克, while 5G(网络) stays
             "g": "克", "m": "米", "s": "秒"}
    unit_pat = "|".join(sorted((re.escape(u) for u in units), key=len,
                               reverse=True))
    text = re.sub(r"(\d+(?:\.\d+)?)\s*(" + unit_pat + r")(?![a-zA-Z²³])",
                  lambda m: zh_read_number(m.group(1)) + units[m.group(2)],
                  text)

    # percent / permille / currency (sign reads OUTSIDE the fraction:
    # -0.25% -> 负百分之零点二五, WeTextProcessing percent tagger)
    def pct(prefix):
        return lambda m: (("负" if m.group(1) else "") + prefix
                          + zh_read_number(m.group(2)))

    text = re.sub(r"(-)?(\d+(?:\.\d+)?)%", pct("百分之"), text)
    text = re.sub(r"(-)?(\d+(?:\.\d+)?)‰", pct("千分之"), text)
    cur = {"¥": "元", "￥": "元", "$": "美元", "€": "欧元", "£": "英镑",
           "₩": "韩元", "HK$": "港元"}
    cur_pat = "|".join(re.escape(c) for c in
                       sorted(cur, key=len, reverse=True))
    # currency amounts accept thousands separators and 万/亿 suffixes:
    # ¥1,234.56 -> 一千二百三十四点五六元; $3万 -> 三万美元
    text = re.sub("(" + cur_pat + r")(\d[\d,]*(?:\.\d+)?)([万亿]*)",
                  lambda m: zh_read_number(m.group(2)) + m.group(3)
                  + cur[m.group(1)], text)

    # arithmetic between numbers: 3+2=5 -> 三加二等于五 (math class)
    ops = {"+": "加", "×": "乘以", "*": "乘以", "÷": "除以", "=": "等于"}
    for _ in range(4):  # chains like 1+2+3=6
        text = re.sub(r"(\d(?:[\d.,]*\d)?)\s*([+×*÷=])\s*(-?\d)",
                      lambda m: m.group(1) + ops[m.group(2)] + m.group(3),
                      text)

    # license plates (WeTextProcessing plate class): 京A88888 digit-wise
    text = re.sub(r"([一-鿿][A-Z])(\d{5,6})(?!\d)",
                  lambda m: m.group(1) + zh_read_digits(m.group(2)), text)

    # negative numbers (after ranges/phones consumed their hyphens)
    text = re.sub(r"(?<![\d\w-])-(\d+(?:\.\d+)?)",
                  lambda m: "负" + zh_read_number(m.group(1)), text)

    # plain numbers (thousands separators included: 12,345 -> 一万二千三百四十五)
    text = re.sub(r"\d{1,3}(?:,\d{3})+(?:\.\d+)?",
                  lambda m: zh_read_number(m.group(0)), text)

    # leading-zero integers surviving to this point are codes (区号010,
    # 房间008): digit-wise, like WeTextProcessing's digit class — NOT
    # int()-collapsed ("零一零", not "十")
    def plain(m):
        tok = m.group(0)
        if tok[0] == "0" and len(tok) > 1 and "." not in tok:
            return zh_read_digits(tok)
        return zh_read_number(tok)

    text = re.sub(r"\d+(?:\.\d+)?", plain, text)
    return text


def en_read_year(y: int) -> str:
    """Year reading (WeTextProcessing/NeMo en date class): 1985 ->
    "nineteen eighty-five", 1906 -> "nineteen oh six", 1900 ->
    "nineteen hundred", 2005 -> "two thousand five"."""
    hi, lo = divmod(y, 100)
    if 2000 <= y <= 2009:
        return "two thousand" + ("" if lo == 0 else " " + en_read_integer(lo))
    if lo == 0:
        return en_read_integer(hi) + " hundred"
    if lo < 10:
        return en_read_integer(hi) + " oh " + en_read_integer(lo)
    return en_read_integer(hi) + " " + en_read_integer(lo)


_EN_MONTHS = ("january", "february", "march", "april", "may", "june",
              "july", "august", "september", "october", "november",
              "december")

_EN_ORD_IRREG = {"one": "first", "two": "second", "three": "third",
                 "five": "fifth", "eight": "eighth", "nine": "ninth",
                 "twelve": "twelfth"}


def _en_ordinal_words(words: str) -> str:
    """Cardinal word string -> ordinal: "twenty-three" -> "twenty-third"."""
    head, sep, last = (words.rpartition("-")
                       if "-" in words.rsplit(" ", 1)[-1]
                       else words.rpartition(" "))
    if last in _EN_ORD_IRREG:
        last = _EN_ORD_IRREG[last]
    elif last.endswith("y"):
        last = last[:-1] + "ieth"
    else:
        last = last + "th"
    return head + sep + last

_ROMAN_VAL = {"I": 1, "V": 5, "X": 10, "L": 50, "C": 100}


def _roman_to_int(s: str) -> int:
    total, prev = 0, 0
    for ch in reversed(s.upper()):
        v = _ROMAN_VAL.get(ch, 0)
        total += -v if v < prev else v
        prev = max(prev, v)
    return total


# whitelist class (WeTextProcessing en whitelist.tsv common subset):
# abbreviation -> spoken form.  St. is context-split below.
_EN_ABBREV = {
    "mr": "mister", "mrs": "missus", "ms": "miss", "dr": "doctor",
    "prof": "professor", "jr": "junior", "sr": "senior",
    "ave": "avenue", "blvd": "boulevard", "rd": "road",
    "dept": "department", "approx": "approximately", "appt": "appointment",
    "apt": "apartment", "est": "established", "vs": "versus",
    "etc": "et cetera",
}


def _en_verbalize(text: str) -> str:
    # ---- whitelist abbreviations (before any digit rule so "No. 5" etc.
    # resolve first).  Dotted forms always expand; undotted only for the
    # unambiguous ones (vs, etc)
    def abbrev(m):
        word = m.group(1)
        out = _EN_ABBREV[word.lower()]
        return out.capitalize() if word[0].isupper() else out

    text = re.sub(r"\b(" + "|".join(_EN_ABBREV) + r")\.(?=\s|$)", abbrev,
                  text, flags=re.IGNORECASE)
    text = re.sub(r"\b(vs|etc)\b(?!\.)", abbrev, text, flags=re.IGNORECASE)
    # St. -> Saint before a capitalized word, Street after one
    text = re.sub(r"\bSt\.(?=\s+[A-Z])", "Saint", text)
    text = re.sub(r"(?<=[a-zA-Z] )St\.?(?=\s|$|,)", "Street", text)
    # No. 5 -> number five (digit rule below reads the 5)
    text = re.sub(r"\b[Nn]o\.\s*(?=\d)", "number ", text)

    def day_ordinal(d: int) -> str:
        return _en_ordinal_words(en_read_integer(d))

    # ---- dates (WeTextProcessing en date class).  MM/DD/YYYY and ISO
    # YYYY-MM-DD read month-name + ordinal day + year; "May 5, 2023" gets
    # the ordinal day.  Before fraction/range rules so the slashes and
    # dashes are consumed as dates, not arithmetic
    def read_date(fallback, mo, d, y):
        if not (1 <= mo <= 12 and 1 <= d <= 31):
            return fallback
        out = _EN_MONTHS[mo - 1] + " " + day_ordinal(d)
        if y is not None:
            out += ", " + en_read_year(int(y))
        return out

    text = re.sub(r"\b(\d{1,2})/(\d{1,2})/(\d{4})\b",
                  lambda m: read_date(m.group(0), int(m.group(1)),
                                      int(m.group(2)), m.group(3)), text)
    text = re.sub(r"\b(\d{4})-(\d{1,2})-(\d{1,2})\b",
                  lambda m: read_date(m.group(0), int(m.group(2)),
                                      int(m.group(3)), m.group(1)), text)

    def month_day(m):
        d = int(m.group(2))
        if not 1 <= d <= 31:
            return m.group(0)
        out = m.group(1) + " " + day_ordinal(d)
        if m.group(3) is not None:
            out += ", " + en_read_year(int(m.group(3)))
        return out

    # no `\.?` after the month: the pattern only names FULL month words,
    # so a dot there could only be a sentence-final period — matching it
    # deleted the boundary and read the next sentence's count as a date
    # ("...in January. 5 minutes later" -> "January fifth minutes")
    months_pat = "|".join(mo.capitalize() for mo in _EN_MONTHS)
    text = re.sub(r"\b(" + months_pat + r")\s+(\d{1,2})"
                  r"(?:,\s*((?:1[1-9]|20)\d\d))?\b(?!\d|\s*[:/])",
                  month_day, text)
    # year directly after a month name ("May 2021", "of May, 2021")
    text = re.sub(r"\b(" + months_pat + r")(,?\s+)((?:1[1-9]|20)\d\d)\b",
                  lambda m: m.group(1) + m.group(2)
                  + en_read_year(int(m.group(3))), text)

    # ---- telephone class: hyphen/paren digit groups read digit-wise with
    # group pauses ("555-1234" -> "five five five, one two three four")
    def phone(m):
        groups = re.findall(r"\d+", m.group(0))
        spoken = [" ".join(en_read_integer(int(c)) if c != "0" else "oh"
                           for c in g) for g in groups]
        return ", ".join(spoken)

    # trailing guard rejects only digit / dot-digit (a decimal tail), not a
    # sentence-final period — "Fax: 212-555-0123." is still a phone
    text = re.sub(r"(?<![\d.])(?:\+?1[-. ])?\(?\d{3}\)?[-. ]\d{3}[-. ]\d{4}"
                  r"(?!\.?\d)", phone, text)
    text = re.sub(r"(?<![\d.-])\d{3}-\d{4}(?!\.?\d)(?!-)", phone, text)

    # ---- roman numerals: structural words read cardinal ("Chapter IV" ->
    # "chapter four"); a capitalized name followed by II..X reads regnal
    # ("Henry VIII" -> "Henry the eighth").  Bare "I" stays the pronoun
    def roman_cardinal(m):
        return m.group(1) + " " + en_read_integer(_roman_to_int(m.group(2)))

    # single letters only count as numerals for I/V/X — "Class C" /
    # "Type C" are letter labels, not 100
    text = re.sub(r"\b(Chapter|Part|Act|Section|Volume|Book|Phase|Stage|"
                  r"Level|Class|Type|Grade|War)\s+"
                  r"([IVXLC]{2,7}|[IVX])\b(?![a-z])",
                  roman_cardinal, text, flags=0)

    def regnal(m):
        n = _roman_to_int(m.group(2))
        return (m.group(1) + " the "
                + _en_ordinal_words(en_read_integer(n)))

    text = re.sub(r"\b([A-Z][a-z]{2,})\s+(XVIII|XVII|XVI|XV|XIV|XIII|XII"
                  r"|XI|X|IX|VIII|VII|VI|V|IV|III|II)\b(?![a-z.])",
                  regnal, text)

    def time_hm(m):
        h, mi = int(m.group(1)), int(m.group(2))
        out = en_read_integer(h)
        if mi == 0:
            out += " o'clock"
        else:
            out += " " + ("oh " + en_read_integer(mi) if mi < 10
                          else en_read_integer(mi))
        if m.group(3) is not None:
            sec = int(m.group(3))
            out += " and " + en_read_integer(sec) + (
                " second" if sec == 1 else " seconds")
        if m.group(4) is not None:
            out += " " + m.group(4).lower()
        return out

    # (?=\W|$) instead of \b: "3:45pm" has no word boundary between the
    # digit and "p", which previously let the raw colon through (and glued
    # "pm" onto the verbalized minutes).  Minutes/seconds restricted to
    # [0-5]\d like the zh time rule — "99:99" is a score/ratio, not a time,
    # and falls through to the other numeric readings
    text = re.sub(r"\b(\d{1,2}):([0-5]\d)(?::([0-5]\d))?\s*([AaPp][Mm])?"
                  r"(?=\W|$)", time_hm, text)

    # years in date context: "in 1985" -> pairs reading; decades 1990s/80s
    def decade(m):
        tok = m.group(1)
        base = en_read_year(int(tok)) if len(tok) == 4 else en_read_integer(
            int(tok))
        head, _, last = base.rpartition(" ")
        if last == "hundred":
            last = "hundreds"
        elif last == "thousand":
            last = "thousands"
        elif last.endswith("y"):
            last = last[:-1] + "ies"
        else:
            last += "s"
        return (head + " " if head else "") + last

    text = re.sub(r"\b((?:1[1-9]|20)\d0|[2-9]0)s\b", decade, text)
    # year ranges BEFORE the context rule ("From 2014-2016": the context
    # word would otherwise consume the first year and orphan the second)
    text = re.sub(r"\b((?:1[1-9]|20)\d\d)[-–]((?:1[1-9]|20)\d\d)\b",
                  lambda m: en_read_year(int(m.group(1))) + " to "
                  + en_read_year(int(m.group(2))), text)
    # IGNORECASE: sentence-initial context words ("Since 1906") must get the
    # year reading too; group(1) passes the original casing through
    text = re.sub(r"\b(in|year|since|from|until|till|by|of|around|circa|"
                  r"early|late|mid)([ -])((?:1[1-9]|20)\d\d)\b",
                  lambda m: m.group(1) + m.group(2)
                  + en_read_year(int(m.group(3))), text, flags=re.IGNORECASE)

    # ordinals: 1st -> first, 23rd -> twenty-third
    def ordinal(m):
        return _en_ordinal_words(en_read_integer(int(m.group(1))))

    text = re.sub(r"\b(\d+)(?:st|nd|rd|th)\b", ordinal, text)
    text = re.sub(r"(\d+(?:\.\d+)?)%",
                  lambda m: en_read_number(m.group(1)) + " percent", text)

    # temperature: -5°C -> "minus five degrees celsius" (measure class)
    text = re.sub(r"(-?)(\d+(?:\.\d+)?)\s*°\s*([CF])\b",
                  lambda m: ("minus " if m.group(1) else "")
                  + en_read_number(m.group(2)) + " degrees "
                  + {"C": "celsius", "F": "fahrenheit"}[m.group(3)], text)

    # money with minor units: $3.50 -> "three dollars fifty cents"
    # (money class; £/€/¥ carry their own major/minor unit words)
    _CURRENCIES = {"$": ("dollar", "dollars", "cent", "cents"),
                   "£": ("pound", "pounds", "penny", "pence"),
                   "€": ("euro", "euros", "cent", "cents"),
                   "¥": ("yen", "yen", "sen", "sen")}

    def money(m):
        maj1, majn, min1, minn = _CURRENCIES[m.group(1)]
        d, c = int(m.group(2).replace(",", "")), m.group(3)
        cents = int(c) if c is not None else 0
        if d == 0 and cents > 0:
            # "$0.50" reads as just the minor-unit phrase
            return en_read_integer(cents) + " " + (min1 if cents == 1
                                                   else minn)
        out = en_read_integer(d) + " " + (maj1 if d == 1 else majn)
        if cents > 0:
            out += " " + en_read_integer(cents) + " " + (
                min1 if cents == 1 else minn)
        return out

    cur_pat = "[" + "".join(re.escape(c) for c in _CURRENCIES) + "]"
    text = re.sub(r"(" + cur_pat + r")(\d{1,3}(?:,\d{3})*|\d+)"
                  r"(?:\.(\d{2}))?(?![\d,]|\.\d)", money, text)
    text = re.sub(r"(" + cur_pat + r")(\d+(?:\.\d+)?)",
                  lambda m: en_read_number(m.group(2)) + " "
                  + _CURRENCIES[m.group(1)][1], text)

    # fractions: 1/2 -> "one half", 3/4 -> "three quarters", 2/5 ->
    # "two fifths" (numerator cardinal + ordinal denominator)
    def fraction(m):
        num, den = int(m.group(1)), int(m.group(2))
        if den == 2:
            d = "half" if num == 1 else "halves"
        elif den == 4:
            d = "quarter" + ("" if num == 1 else "s")
        else:
            d = ordinal(_FakeMatch(str(den)))
            if num != 1:
                d += "s"
        return en_read_integer(num) + " " + d

    class _FakeMatch:
        def __init__(self, s):
            self.s = s

        def group(self, i):
            return self.s

    # (no '/'-adjacency so 05/06/2023 date slashes are left alone)
    text = re.sub(r"(?<![\d/])(\d{1,2})/(\d{1,3})(?![\d/])", fraction, text)

    # equation minus BEFORE ranges: "5-3=2" must read "five minus three
    # equals two", not fall to the range rule (which would strand the '=')
    text = re.sub(r"(\d)\s*-\s*(?=\d[\d.,\s]*=)", r"\1 minus ", text)

    # numeric ranges: "pages 3-5" -> "three to five" (phones/dates already
    # consumed their hyphen shapes above)
    text = re.sub(r"(?<![\d.-])(\d{1,4}(?:\.\d+)?)[-–~](\d{1,4}(?:\.\d+)?)"
                  r"(?![\d.-])",
                  lambda m: en_read_number(m.group(1)) + " to "
                  + en_read_number(m.group(2)), text)

    # math chains: 3+2=5 -> "three plus two equals five" (math class);
    # equation '-' was already converted to "minus" before the range rule
    _OPS = {"+": "plus", "×": "times", "*": "times", "÷": "divided by",
            "=": "equals"}
    for _ in range(4):
        text = re.sub(r"(\d(?:[\d.,]*\d)?)\s*([+×*÷=])\s*(-?\d)",
                      lambda m: m.group(1) + " " + _OPS[m.group(2)] + " "
                      + m.group(3), text)

    # negative numbers (after ranges/phones consumed their hyphens)
    text = re.sub(r"(?<![\d\w-])-(\d+(?:\.\d+)?)",
                  lambda m: "minus " + en_read_number(m.group(1)), text)

    # number-adjacent measure abbreviations (measure class subset; only
    # directly after a number so bare words stay words)
    _UNITS = {"km": "kilometer", "cm": "centimeter", "mm": "millimeter",
              "kg": "kilogram", "ft": "foot", "mi": "mile", "lb": "pound",
              "lbs": "pounds", "oz": "ounce", "mph": "miles per hour",
              "ml": "milliliter", "kmh": "kilometers per hour"}
    _UNIT_PLURAL = {"foot": "feet", "pounds": "pounds",
                    "miles per hour": "miles per hour",
                    "kilometers per hour": "kilometers per hour"}

    def unit(m):
        n, u = m.group(1), _UNITS[m.group(2).lower()]
        if float(n) != 1:
            u = _UNIT_PLURAL.get(u, u + "s")
        return n + " " + u

    text = re.sub(r"(\d+(?:\.\d+)?) ?(" + "|".join(_UNITS) + r")\b",
                  unit, text, flags=re.IGNORECASE)
    # split letter-digit boundaries so "beta2" reads "beta two" and
    # "F5-TTS" reads "f five-tts" (reference `front.py:473-476` cases)
    text = re.sub(r"([a-zA-Z])(\d)", r"\1 \2", text)
    text = re.sub(r"(\d)([a-zA-Z])", r"\1 \2", text)

    # leading-zero integers surviving to this point are codes ("Room 008"):
    # digit-wise with "oh", matching the phone reading — NOT int-collapsed
    def plain(m):
        tok = m.group(0)
        if tok[0] == "0" and len(tok) > 1 and "." not in tok:
            return " ".join("oh" if c == "0" else en_read_integer(int(c))
                            for c in tok)
        return en_read_number(tok)

    text = re.sub(r"\d+(?:\.\d+)?(?:,\d{3})*", plain, text)
    return text


class TextNormalizer:
    """Reference-compatible surface: `load()` + `normalize(text)`
    (`utils/front.py:11-228`)."""

    def __init__(self):
        self.loaded = False

    def load(self):
        self.loaded = True

    def match_email(self, email: str) -> bool:
        return re.match(r"^[a-zA-Z0-9]+@[a-zA-Z0-9]+\.[a-zA-Z]+$", email) is not None

    def use_chinese(self, s: str) -> bool:
        has_chinese = bool(re.search(r"[一-鿿]", s))
        has_alpha = bool(re.search(r"[a-zA-Z]", s))
        if has_chinese or not has_alpha or self.match_email(s):
            return True
        return bool(re.search(PINYIN_TONE_PATTERN, s, re.IGNORECASE))

    # -- placeholder save/restore (same scheme as the reference) --------
    def _save(self, text: str, pattern: str, tag: str) -> Tuple[str, List[str]]:
        found = re.findall(pattern, text, re.IGNORECASE)
        if not found:
            return text, []
        items = list(dict.fromkeys("".join(f) for f in found))
        for i, item in enumerate(items):
            text = text.replace(item, f"<{tag}_{chr(ord('a') + i)}>")
        return text, items

    def _restore(self, text: str, items: List[str], tag: str,
                 transform=None) -> str:
        for i, item in enumerate(items):
            if transform:
                item = transform(item)
            text = text.replace(f"<{tag}_{chr(ord('a') + i)}>", item)
        return text

    def correct_pinyin(self, pinyin: str) -> str:
        """jqx + u/ü -> v (reference `front.py:146-157`)."""
        if pinyin[0] not in "jqxJQX":
            return pinyin
        pinyin = re.sub(r"([jqx])[uü](n|e|an)*(\d)", r"\g<1>v\g<2>\g<3>",
                        pinyin, flags=re.IGNORECASE)
        return pinyin.upper()

    def normalize(self, text: str) -> str:
        text = re.sub(ENGLISH_CONTRACTION_PATTERN, r"\1 is", text,
                      flags=re.IGNORECASE)
        if self.use_chinese(text):
            text, pinyins = self._save(text.rstrip(), PINYIN_TONE_PATTERN, "pinyin")
            text, names = self._save(text, NAME_PATTERN, "n")
            result = _zh_verbalize(text)
            result = self._restore(result, names, "n")
            result = self._restore(result, pinyins, "pinyin", self.correct_pinyin)
            rep = ZH_CHAR_REP_MAP
        else:
            result = _en_verbalize(text)
            rep = CHAR_REP_MAP
        pattern = re.compile("|".join(re.escape(p) for p in rep))
        return pattern.sub(lambda m: rep[m.group()], result)
