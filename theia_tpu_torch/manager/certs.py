"""TLS certificate subsystem for the manager.

Re-provides pkg/apiserver/certificate/: self-signed serving certificates
generated at startup (generateSelfSignedCertificate, certificate.go:103),
or operator-provided cert/key pairs (ApplyServerCert :52), with the CA
certificate published to a well-known location so clients can trust the
server — the reference publishes to the `theia-ca` ConfigMap
(cacert_controller.go); here it's a PEM file the CLI reads via
--ca-cert. Rotation = regenerate when the cert is within
`rotate_before` of expiry.
"""

from __future__ import annotations

import datetime
import ipaddress
import os
from typing import Optional, Tuple

from cryptography import x509
from cryptography.hazmat.primitives import hashes, serialization
from cryptography.hazmat.primitives.asymmetric import rsa
from cryptography.x509.oid import NameOID

DEFAULT_VALIDITY_DAYS = 365
DEFAULT_ROTATE_BEFORE = datetime.timedelta(days=30)
CA_CERT_FILENAME = "theia-ca.crt"   # the `theia-ca` ConfigMap analogue


def generate_self_signed(
        common_name: str = "theia-manager",
        dns_names: Tuple[str, ...] = ("localhost", "theia-manager"),
        validity_days: int = DEFAULT_VALIDITY_DAYS) -> Tuple[bytes, bytes]:
    """(cert_pem, key_pem) for a self-signed serving certificate."""
    key = rsa.generate_private_key(public_exponent=65537, key_size=2048)
    name = x509.Name(
        [x509.NameAttribute(NameOID.COMMON_NAME, common_name)])
    now = datetime.datetime.now(datetime.timezone.utc)
    san = x509.SubjectAlternativeName(
        [x509.DNSName(d) for d in dns_names]
        + [x509.IPAddress(ipaddress.ip_address("127.0.0.1"))])
    cert = (x509.CertificateBuilder()
            .subject_name(name).issuer_name(name)
            .public_key(key.public_key())
            .serial_number(x509.random_serial_number())
            .not_valid_before(now - datetime.timedelta(minutes=5))
            .not_valid_after(now + datetime.timedelta(
                days=validity_days))
            .add_extension(san, critical=False)
            .add_extension(x509.BasicConstraints(ca=True,
                                                 path_length=None),
                           critical=True)
            .sign(key, hashes.SHA256()))
    cert_pem = cert.public_bytes(serialization.Encoding.PEM)
    key_pem = key.private_bytes(
        serialization.Encoding.PEM,
        serialization.PrivateFormat.TraditionalOpenSSL,
        serialization.NoEncryption())
    return cert_pem, key_pem


def cert_expiry(cert_pem: bytes) -> datetime.datetime:
    return x509.load_pem_x509_certificate(
        cert_pem).not_valid_after_utc


def needs_rotation(cert_pem: bytes,
                   rotate_before: datetime.timedelta =
                   DEFAULT_ROTATE_BEFORE) -> bool:
    now = datetime.datetime.now(datetime.timezone.utc)
    return cert_expiry(cert_pem) - now < rotate_before


def apply_server_cert(cert_dir: str,
                      provided_cert: Optional[str] = None,
                      provided_key: Optional[str] = None,
                      provided_ca: Optional[str] = None
                      ) -> Tuple[str, str, str]:
    """Ensure serving cert/key exist; returns (cert, key, ca) paths.

    Provided cert/key are used as-is (reference ApplyServerCert's
    provided-secret path) with `provided_ca` as the published issuer
    bundle; otherwise a self-signed pair is generated, reusing an
    existing one unless it needs rotation, and the cert itself is the
    CA. The CA is published to CA_CERT_FILENAME (the `theia-ca`
    ConfigMap analogue).
    """
    os.makedirs(cert_dir, exist_ok=True)
    ca_path = os.path.join(cert_dir, CA_CERT_FILENAME)
    if bool(provided_cert) != bool(provided_key):
        raise ValueError(
            "provided cert/key must be given together "
            f"(cert={provided_cert!r}, key={provided_key!r})")
    if provided_cert and provided_key:
        # Publish the issuing CA when given; a non-self-signed leaf in
        # a client trust store is not generally accepted.
        ca_src = provided_ca or provided_cert
        with open(ca_src, "rb") as f:
            ca_bytes = f.read()
        with open(ca_path, "wb") as f:
            f.write(ca_bytes)
        return provided_cert, provided_key, ca_path

    cert_path = os.path.join(cert_dir, "tls.crt")
    key_path = os.path.join(cert_dir, "tls.key")
    regenerate = True
    if os.path.exists(cert_path) and os.path.exists(key_path):
        with open(cert_path, "rb") as f:
            existing = f.read()
        regenerate = needs_rotation(existing)
    if regenerate:
        cert_pem, key_pem = generate_self_signed()
        with open(cert_path, "wb") as f:
            f.write(cert_pem)
        fd = os.open(key_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC,
                     0o600)
        with os.fdopen(fd, "wb") as f:
            f.write(key_pem)
    with open(cert_path, "rb") as f:
        cert_bytes = f.read()
    with open(ca_path, "wb") as f:
        f.write(cert_bytes)
    return cert_path, key_path, ca_path
