"""Chinese number verbalization for the text front-end.

Behavior parity with the reference's NumberNormalizer
(text_normalizers/number_normalizer.py:29-245): special named numbers, score
ratios, phone numbers, temperatures, year readings, percentages, then generic
numbers. Intentional deviation: the reference crashes on negative numbers
(`num_str["-"]` TypeError at number_normalizer.py:108); we read the sign as 负.
"""

from __future__ import annotations

import re

_DIGITS = {
    "1": "一", "2": "二", "3": "三", "4": "四", "5": "五",
    "6": "六", "7": "七", "8": "八", "9": "九", "0": "零",
    ".": "点", "+": "正", "-": "负", ":": "比",
}

# Fixed phrases whose digits are read digit-by-digit in a conventional way.
_SPECIAL = {
    "Ⅰ": "一", "Ⅱ": "二", "Ⅲ": "三", "Ⅳ": "四", "Ⅴ": "五",
    "Ⅵ": "六", "Ⅶ": "七", "Ⅷ": "八", "Ⅸ": "九",
    "火警119": "火警幺幺九", "美国911": "美国九幺幺", "911事件": "九幺幺事件",
    "120急救": "幺二零急救", "123木头人": "一二三木头人", "代号47": "代号四十七",
    "77年航空港": "七七年航空港", "火箭少女101": "火箭少女一零一",
    "京东618": "京东六幺八", "双11": "双十一", "98k": "九八k", "98K": "九八k",
    "315晚会": "三幺五晚会", "360浏览器": "三六零浏览器",
    "360安全卫士": "三六零安全卫士", "360安全浏览器": "三六零安全浏览器",
    "OPPO R17": "OPPO R十七", "50 Cent": "五十Cent", "创造101": "创造幺零幺",
    "歌曲9420": "歌曲九四二零", "123小红军": "一二三小红军",
    "1234喜欢": "一二三四喜欢", "英伦86": "英伦八六", "985工程": "九八五工程",
    "985大学": "九八五大学", "211工程": "二幺幺工程", "211大学": "二幺幺大学",
    "2011计划": "二零幺幺计划", "87版": "八七版",
    "2019尖锋之夜": "二零一九尖锋之夜", "8486网": "八四八六网",
    "黑太阳731": "黑太阳七三幺", "2018中国好声音": "二零一八中国好声音",
    "58同城": "五八同城",
}

_NUMBER_RE = re.compile(r"[\-]?[0-9]+(\.[0-9]+)*")
_RATIO_RE = re.compile(r"[\-]?[0-9\.]+\:[\-]?[0-9\.]+(\:[\-]?[0-9\.]+)*")
_PHONE_RE = re.compile(
    r"(编码:|传真:|电话:|号:|号码:|拨|编码|呼叫|拨打|传真号|传真|电话|号|号码|号码是|电话是|号是|打|致电|代码)([0-9\-]+)"
)
_TEMP_RE = re.compile(r"([\-]?[0-9]+)(摄氏度|度)")
_PERCENT_RE = re.compile(r"([\-]?[0-9]+(\.[0-9]+)*)(\%)")
_COUNT_YEAR_RE1 = re.compile(
    r"(前|后|过|过了|活|借|有|命是|死了|活了|存在了|生存了|持续了|持续|维持了|延续了|延续|保存了|保存|保质)([0-9]{4})"
)
_COUNT_YEAR_RE2 = re.compile(r"([0-9]{4})(年前|年后|年寿|年以前|年以后|年之前|年之后|过后)")
_YEAR_RE = re.compile(r"([0-9]{4})(年)")

_SCALE = ["", "十", "百", "千", "万", "十", "百", "千", "亿", "十", "百", "千", "万", "十", "百", "千"]


def _digits_verbatim(num_str: str, one_as_yao: bool = False) -> str:
    table = dict(_DIGITS, **({"1": "幺"} if one_as_yao else {}))
    return "".join(table[d] for d in num_str)


def _integer(num_str: str) -> str:
    if len(num_str) == 1:
        return _DIGITS[num_str]
    out = ""
    n = len(num_str)
    for i, d in enumerate(num_str):
        place = n - i - 1
        if d == "0":
            if place == 4:
                if out and out[-1] == "零":
                    out = out[:-1]
                if not out or out[-1] != "亿":
                    out += "万"
            elif place == 8:
                if out and out[-1] == "零":
                    out = out[:-1]
                out += "亿"
            elif out and out[-1] != "零":
                out += "零"
        else:
            out += _DIGITS[d] + _SCALE[place]
    if out.endswith("零") and len(out) > 1:
        out = out[:-1]
    if out.startswith("一十"):
        out = out[1:]
    return out


def read_number(num_str: str) -> str:
    """Read a (possibly signed / decimal) number the natural way."""
    prefix = ""
    if num_str.startswith("-"):
        prefix = "负"
        num_str = num_str.lstrip("-")
    num_str = num_str.replace("-", "")
    parts = num_str.split(".")
    if len(num_str) > 20 or len(parts) > 2 or len(parts[0]) > 15:
        return prefix + _digits_verbatim(num_str)
    out = _integer(parts[0])
    if len(parts) > 1:
        out += "点" + _digits_verbatim(parts[1])
    return prefix + out


def normalize_numbers(text: str) -> str:
    """Verbalize all digit sequences in `text` as Chinese words."""
    for k, v in _SPECIAL.items():
        text = text.replace(k, v)

    def ratio(m):
        return "".join(
            "比" if p == ":" else read_number(p) for p in re.split(r"(:)", m.group(0))
        )

    def phone(m):
        return m.group(1) + _digits_verbatim(m.group(2).replace("-", ""), one_as_yao=True)

    def temp(m):
        return read_number(m.group(1)).replace("负", "零下") + m.group(2)

    def count_year(m):
        return _NUMBER_RE.sub(lambda n: read_number(n.group(0)), m.group(0))

    def plain_year(m):
        return _digits_verbatim(m.group(1)) + m.group(2)

    def percent(m):
        body = _NUMBER_RE.sub(lambda n: read_number(n.group(0)), m.group(0))
        return ("百分之" + body).replace("%", "")

    text = _RATIO_RE.sub(ratio, text)
    text = _PHONE_RE.sub(phone, text)
    text = _TEMP_RE.sub(temp, text)
    text = _COUNT_YEAR_RE1.sub(count_year, text)
    text = _COUNT_YEAR_RE2.sub(count_year, text)
    text = _YEAR_RE.sub(plain_year, text)
    text = _PERCENT_RE.sub(percent, text)
    text = _NUMBER_RE.sub(lambda m: read_number(m.group(0)), text)
    return text
