"""Authenticated identity for node RPCs: minimal HS256 JWT.

Port of ``primia_tpu/serve/auth.py``, a copy (reference
``Node/app/main/routes/model_centric/routes.py:37-90`` and the role table
of ``Node/app/__init__.py:62-149``). Standard RFC 7519 HS256 tokens
(header.payload.signature, base64url, HMAC-SHA256) carry ``sub`` (worker
id), ``role`` and ``exp``; a node started with an ``auth_secret`` requires
a valid token on every gated verb, and the role gates mirror the
reference's capability flags. A token minted by either package verifies
in the other.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import json
import time
from typing import Any, Dict, Optional

# role -> capabilities, mirroring the reference's seeded role table
# (Node/app/__init__.py:62-149: can_triage_requests /
#  can_edit_settings / can_create_users / can_edit_roles /
#  can_manage_infrastructure, plus implicit FL-cycle participation)
ROLES: Dict[str, Dict[str, bool]] = {
    "user": {"fl_participate": True, "host": False, "admin": False},
    "compliance_officer": {"fl_participate": True, "host": False, "admin": False},
    "administrator": {"fl_participate": True, "host": True, "admin": True},
    "owner": {"fl_participate": True, "host": True, "admin": True},
}


class AuthError(Exception):
    """Raised on missing/expired/forged tokens or insufficient role."""


def _b64url(data: bytes) -> str:
    return base64.urlsafe_b64encode(data).rstrip(b"=").decode("ascii")


def _unb64url(s: str) -> bytes:
    pad = "=" * (-len(s) % 4)
    return base64.urlsafe_b64decode(s + pad)


def issue_token(secret: bytes, sub: str, role: str = "user",
                ttl_s: float = 24 * 3600,
                extra: Optional[Dict[str, Any]] = None) -> str:
    """Mint an HS256 JWT for ``sub`` with the given role."""
    if role not in ROLES:
        raise ValueError(f"unknown role {role!r}; one of {sorted(ROLES)}")
    header = {"alg": "HS256", "typ": "JWT"}
    payload = {"sub": sub, "role": role, "exp": time.time() + ttl_s}
    if extra:
        payload.update(extra)
    signing_input = (
        _b64url(json.dumps(header, separators=(",", ":")).encode())
        + "."
        + _b64url(json.dumps(payload, separators=(",", ":")).encode())
    )
    sig = hmac.new(secret, signing_input.encode("ascii"), hashlib.sha256).digest()
    return signing_input + "." + _b64url(sig)


def verify_token(secret: bytes, token: str) -> Dict[str, Any]:
    """Validate signature + expiry; returns the claims dict."""
    try:
        h_b64, p_b64, s_b64 = token.split(".")
    except (ValueError, AttributeError):
        raise AuthError("malformed token")
    signing_input = (h_b64 + "." + p_b64).encode("ascii")
    expected = hmac.new(secret, signing_input, hashlib.sha256).digest()
    if not hmac.compare_digest(expected, _unb64url(s_b64)):
        raise AuthError("bad signature")
    header = json.loads(_unb64url(h_b64))
    if header.get("alg") != "HS256":  # no alg-confusion downgrade
        raise AuthError(f"unsupported alg {header.get('alg')!r}")
    claims = json.loads(_unb64url(p_b64))
    if float(claims.get("exp", 0)) < time.time():
        raise AuthError("token expired")
    if claims.get("role") not in ROLES:
        raise AuthError(f"unknown role {claims.get('role')!r}")
    return claims


def require(claims: Dict[str, Any], capability: str) -> None:
    """Gate a verb on a role capability (reference can_* flags)."""
    role = claims.get("role")
    caps = ROLES.get(role, {})
    if not caps.get(capability, False):
        raise AuthError(f"role {role!r} lacks capability {capability!r}")
