# The port's copy of weaviate_tpu/entities/phone.py, its imports pointed at the port.
"""phoneNumber data-type parsing.

Reference: entities/models/phone_number.go (the payload shape) and
usecases/objects/validation/phone_numbers.go (validate-and-parse at
import: {input, defaultCountry} in, read-only parsed fields out). The
reference leans on libphonenumber; this implementation covers its
validation contract with a compact country-calling-code table: enough to
parse international (+CC...) inputs for any country and national inputs
for the countries in the table, flagging everything else invalid rather
than guessing.
"""

from __future__ import annotations

import re

# ISO 3166-1 alpha-2 -> calling code (the common set; extend as needed)
COUNTRY_CODES = {
    "us": 1, "ca": 1, "de": 49, "gb": 44, "fr": 33, "nl": 31, "be": 32,
    "es": 34, "it": 39, "at": 43, "ch": 41, "se": 46, "no": 47, "dk": 45,
    "fi": 358, "pl": 48, "cz": 420, "pt": 351, "ie": 353, "gr": 30,
    "au": 61, "nz": 64, "jp": 81, "kr": 82, "cn": 86, "in": 91, "br": 55,
    "mx": 52, "ar": 54, "za": 27, "il": 972, "sg": 65, "hk": 852,
    "tw": 886, "tr": 90, "ru": 7, "ua": 380, "ng": 234, "eg": 20,
}
# calling codes sorted longest-first for prefix matching of +CC numbers
_CC_BY_LENGTH = sorted({str(c) for c in COUNTRY_CODES.values()},
                       key=len, reverse=True)

# countries where the leading 0 is PART of the national number (no trunk
# prefix to strip — e.g. Rome numbers start with 06)
_NO_TRUNK_STRIP = {"it"}

_DIGITS = re.compile(r"\d+")


class PhoneNumberError(ValueError):
    pass


def parse_phone_number(value: dict, prop_name: str = "", class_name: str = "") -> dict:
    """Validate + parse a phoneNumber property value.

    -> the stored payload: {input, defaultCountry?, countryCode, national,
    nationalFormatted, internationalFormatted, valid} — phone_number.go's
    shape, with the read-only fields computed here.
    Raises PhoneNumberError on malformed values (validation.go semantics:
    a map with a non-empty string `input` is required; national numbers
    need defaultCountry)."""
    where = f" property {prop_name!r} on class {class_name!r}" if prop_name else ""
    if not isinstance(value, dict):
        raise PhoneNumberError(
            f"invalid phoneNumber{where}: must be a map, got {type(value).__name__}")
    raw = value.get("input")
    if not isinstance(raw, str) or not raw.strip():
        raise PhoneNumberError(
            f"invalid phoneNumber{where}: 'input' must be a non-empty string")
    default_country = str(value.get("defaultCountry", "") or "").lower()
    if default_country and default_country not in COUNTRY_CODES:
        raise PhoneNumberError(
            f"invalid phoneNumber{where}: unknown defaultCountry "
            f"{value.get('defaultCountry')!r}")

    digits = "".join(_DIGITS.findall(raw))
    out = {
        "input": raw,
        "valid": False,
        "countryCode": 0,
        "national": 0,
        "nationalFormatted": "",
        "internationalFormatted": "",
    }
    if default_country:
        out["defaultCountry"] = value.get("defaultCountry")

    if raw.strip().startswith("+") or raw.strip().startswith("00"):
        body = digits[2:] if raw.strip().startswith("00") else digits
        cc = next((c for c in _CC_BY_LENGTH if body.startswith(c)), None)
        if cc is None:
            return out  # unknown country prefix: stored, flagged invalid
        national = body[len(cc):]
        # the "(0)" notation marks an explicit trunk zero that is NOT part
        # of the dialable international number; a bare leading zero is kept
        # (it is significant in e.g. Italy), matching what the caller wrote
        if "(0)" in raw.replace(" ", "") and national.startswith("0"):
            national = national[1:]
    else:
        if not default_country:
            raise PhoneNumberError(
                f"invalid phoneNumber{where}: national number requires "
                "'defaultCountry' (ISO 3166-1 alpha-2)")
        cc = str(COUNTRY_CODES[default_country])
        national = digits
        # drop ONE trunk zero for trunk-zero countries (most of the table);
        # countries whose national numbers keep the zero are exempt
        if national.startswith("0") and default_country not in _NO_TRUNK_STRIP:
            national = national[1:]

    if not (4 <= len(national) <= 14):
        return out
    out.update(
        valid=True,
        countryCode=int(cc),
        national=int(national),
        nationalFormatted=national,
        internationalFormatted=f"+{cc} {national}",
    )
    return out
