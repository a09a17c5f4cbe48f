"""The port's bootstrap-layer encryption (encryption/, converter/content.py,
remote/registry.Descriptor) against the JAX package's.

Mirrors the encryption cases of tests/test_security.py (round trip,
several recipients, a wrong key, ``unwrap_only``, media types, the
annotation filter, the content-store flow), each run in both packages,
with cross-package round trips: a layer encrypted by one package decrypts
with the other's ``decrypt_layer``, and a content store written by one is
read by the other. The layer cipher is randomised (AES-GCM key, nonce,
RSA-OAEP wrap), so the packages are held to each other's output, never to
equal ciphertext.
"""

from __future__ import annotations

import hashlib
import importlib.util

import pytest

from nydus_snapshotter_tpu import encryption as jenc
from nydus_snapshotter_tpu.converter.content import LocalContentStore as JStore
from nydus_snapshotter_tpu.remote.registry import Descriptor as JDescriptor
from nydus_snapshotter_tpu_torch import constants as C
from nydus_snapshotter_tpu_torch import encryption as penc
from nydus_snapshotter_tpu_torch.converter.content import LocalContentStore
from nydus_snapshotter_tpu_torch.encryption.encryption import EncryptionError
from nydus_snapshotter_tpu_torch.remote.registry import Descriptor
from nydus_snapshotter_tpu_torch.utils import errdefs

requires_crypto = pytest.mark.skipif(
    importlib.util.find_spec("cryptography") is None, reason="cryptography not installed"
)

# (package, its Descriptor) for each side of a round trip
PORT = (penc, Descriptor)
REF = (jenc, JDescriptor)
PAIRS = [pytest.param(a, b, id=f"{na}-{nb}") for (na, a), (nb, b) in
         [(("port", PORT), ("port", PORT)), (("port", PORT), ("ref", REF)),
          (("ref", REF), ("port", PORT))]]


def _keypair():
    from nydus_snapshotter_tpu.utils.signer import generate_keypair

    return generate_keypair()


@pytest.fixture(scope="module")
def keypair():
    return _keypair()


def _desc(cls, data: bytes, media="application/vnd.oci.image.layer.v1.tar+gzip"):
    return cls(
        media_type=media,
        digest="sha256:" + hashlib.sha256(data).hexdigest(),
        size=len(data),
        annotations={C.LAYER_ANNOTATION_NYDUS_BOOTSTRAP: "true"},
    )


def _as(cls, desc):
    """A descriptor of one package as the other's, through its JSON form."""
    return cls.from_json(desc.to_json())


@requires_crypto
class TestEncryption:
    @pytest.mark.parametrize("enc,dec", PAIRS)
    def test_encrypt_decrypt_roundtrip(self, keypair, enc, dec):
        priv, pub = keypair
        (emod, ecls), (dmod, dcls) = enc, dec
        data = b"the nydus bootstrap layer" * 50
        desc = _desc(ecls, data)
        enc_desc, ciphertext = emod.encrypt_layer(data, desc, [pub])
        assert enc_desc.media_type == penc.MEDIA_TYPE_LAYER_GZIP_ENC
        assert penc.ANNOTATION_ENC_KEYS_JWE in enc_desc.annotations
        assert ciphertext != data
        plain_desc, plaintext = dmod.decrypt_layer(ciphertext, _as(dcls, enc_desc), [priv])
        assert plaintext == data
        assert plain_desc.digest == desc.digest
        # the plain media type is the reference's mapping back (docker's)
        assert plain_desc.media_type == "application/vnd.docker.image.rootfs.diff.tar.gzip"
        assert plain_desc.annotations == desc.annotations

    @pytest.mark.parametrize("enc,dec", PAIRS)
    def test_multiple_recipients(self, enc, dec):
        (emod, ecls), (dmod, dcls) = enc, dec
        (priv1, pub1), (priv2, pub2) = _keypair(), _keypair()
        data = b"secret"
        enc_desc, ciphertext = emod.encrypt_layer(data, _desc(ecls, data), [pub1, pub2])
        for priv in (priv1, priv2):
            assert dmod.decrypt_layer(ciphertext, _as(dcls, enc_desc), [priv])[1] == data

    def test_wrong_key_rejected(self, keypair):
        _, pub = keypair
        wrong_priv, _ = _keypair()
        enc_desc, ciphertext = penc.encrypt_layer(b"secret", _desc(Descriptor, b"secret"), [pub])
        with pytest.raises(EncryptionError):
            penc.decrypt_layer(ciphertext, enc_desc, [wrong_priv])
        with pytest.raises(jenc.encryption.EncryptionError):
            jenc.decrypt_layer(ciphertext, _as(JDescriptor, enc_desc), [wrong_priv])

    @pytest.mark.parametrize("enc,dec", PAIRS)
    def test_unwrap_only_does_not_decrypt(self, keypair, enc, dec):
        priv, pub = keypair
        (emod, ecls), (dmod, dcls) = enc, dec
        enc_desc, ciphertext = emod.encrypt_layer(b"secret", _desc(ecls, b"secret"), [pub])
        assert dmod.decrypt_layer(ciphertext, _as(dcls, enc_desc), [priv], unwrap_only=True) == (None, None)

    def test_unsupported_media_type(self, keypair):
        _, pub = keypair
        with pytest.raises(EncryptionError, match="unsupported layer MediaType"):
            penc.encrypt_layer(b"x", _desc(Descriptor, b"x", media="application/weird"), [pub])
        with pytest.raises(EncryptionError, match="no encryption recipients"):
            penc.encrypt_layer(b"x", _desc(Descriptor, b"x"), [])
        with pytest.raises(EncryptionError, match="unsupported layer MediaType"):
            penc.decrypt_layer(b"x", _desc(Descriptor, b"x"), [])

    @pytest.mark.parametrize(
        "media",
        ["application/vnd.docker.image.rootfs.diff.tar", "application/vnd.oci.image.layer.v1.tar+zstd",
         "application/vnd.oci.image.layer.v1.tar", penc.MEDIA_TYPE_LAYER_ZSTD_ENC],
    )
    def test_media_type_mapping_matches_reference(self, keypair, media):
        priv, pub = keypair
        pd, ct = penc.encrypt_layer(b"d", _desc(Descriptor, b"d", media=media), [pub])
        jd, _jct = jenc.encrypt_layer(b"d", _desc(JDescriptor, b"d", media=media), [pub])
        assert pd.media_type == jd.media_type
        back = penc.decrypt_layer(ct, pd, [priv])[0]
        assert back.to_json() == jenc.decrypt_layer(ct, _as(JDescriptor, pd), [priv])[0].to_json()

    def test_filter_out_annotations(self):
        annos = {
            "org.opencontainers.image.enc.keys.jwe": "x",
            "org.opencontainers.image.enc.pubopts": "y",
            "other": "keep",
        }
        assert penc.filter_out_annotations(annos) == jenc.filter_out_annotations(annos) == {"other": "keep"}
        assert penc.filter_out_annotations(None) == {}

    @pytest.mark.parametrize("enc,dec", PAIRS)
    def test_content_store_flow(self, keypair, tmp_path, enc, dec):
        """Encrypt through one package's store, decrypt through the other's
        store over the same directory."""
        priv, pub = keypair
        (emod, ecls), (dmod, dcls) = enc, dec
        ecs = (LocalContentStore if emod is penc else JStore)(str(tmp_path))
        dcs = (LocalContentStore if dmod is penc else JStore)(str(tmp_path))
        data = b"bootstrap in the content store"
        info = ecs.write_blob(data)
        enc_desc = emod.encrypt_nydus_bootstrap(ecs, _desc(ecls, data), [pub])
        assert dcs.exists(enc_desc.digest)
        plain_desc = dmod.decrypt_nydus_bootstrap(dcs, _as(dcls, enc_desc), [priv])
        assert dcs.read(plain_desc.digest) == data and plain_desc.digest == info.digest
        assert dmod.decrypt_nydus_bootstrap(dcs, _as(dcls, enc_desc), [priv], unwrap_only=True) is None


class TestContentStore:
    def test_write_read_labels(self, tmp_path):
        cs = LocalContentStore(str(tmp_path))
        info = cs.write_blob(b"hello", labels={"a": "1"})
        assert cs.read(info.digest) == b"hello"
        cs.update_labels(info.digest, {"b": "2"})
        assert cs.info(info.digest).labels == {"a": "1", "b": "2"}
        jinfo = JStore(str(tmp_path)).info(info.digest)
        assert (jinfo.digest, jinfo.size, jinfo.labels) == (info.digest, 5, {"a": "1", "b": "2"})

    def test_digest_mismatch_rejected(self, tmp_path):
        with pytest.raises(errdefs.InvalidArgument):
            LocalContentStore(str(tmp_path)).write_blob(b"data", expected_digest="sha256:" + "0" * 64)

    def test_missing_blob_raises(self, tmp_path):
        with pytest.raises(errdefs.NotFound):
            LocalContentStore(str(tmp_path)).read("sha256:" + "1" * 64)

    def test_walk_and_delete(self, tmp_path):
        cs = LocalContentStore(str(tmp_path))
        a = cs.write_blob(b"a")
        b = JStore(str(tmp_path)).write_blob(b"b", labels={"x": "y"})
        assert {i.digest for i in cs.walk()} == {a.digest, b.digest}
        cs.delete(a.digest)
        assert {i.digest for i in cs.walk()} == {b.digest}
        assert cs.info(b.digest).labels == {"x": "y"}


class TestDescriptor:
    @pytest.mark.parametrize(
        "obj",
        [
            {"mediaType": "m", "digest": "sha256:ab", "size": 3},
            {"mediaType": "m", "digest": "sha256:ab", "size": 3, "annotations": {"k": "v"},
             "urls": ["http://x"], "platform": {"os": "linux"}},
        ],
    )
    def test_json_roundtrip_matches_reference(self, obj):
        d = Descriptor.from_json(obj)
        assert d.to_json() == JDescriptor.from_json(obj).to_json() == obj

    @pytest.mark.parametrize(
        "obj",
        [{}, {"digest": ""}, {"digest": "d", "size": "3"}, {"digest": "d", "size": True},
         {"digest": "d", "annotations": [1]}, {"digest": "d", "urls": {"u": 1}},
         {"digest": "d", "platform": 1}, {"digest": "d", "mediaType": 5}],
    )
    def test_malformed_refused_like_reference(self, obj):
        with pytest.raises(ValueError) as want:
            JDescriptor.from_json(obj)
        with pytest.raises(ValueError, match=str(want.value)):
            Descriptor.from_json(obj)
