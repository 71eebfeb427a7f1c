# The port's copy of weaviate_tpu/modules/backup_cloud.py, its imports pointed at the port.
"""Cloud backup backends: S3 (SigV4), GCS (bearer token), Azure Blob (SAS).

Reference: modules/backup-s3 (minio SDK), backup-gcs, backup-azure. Here the
wire protocols are implemented directly on the standard library:

- S3: AWS Signature Version 4 signing (AWS4-HMAC-SHA256) over virtual-host
  or path-style URLs; works against AWS and any S3-compatible store
  (minio). Credentials: AWS_ACCESS_KEY_ID / AWS_SECRET_ACCESS_KEY /
  BACKUP_S3_BUCKET / BACKUP_S3_ENDPOINT / AWS_REGION.
- GCS: JSON API with a caller-provided OAuth bearer token
  (BACKUP_GCS_TOKEN + BACKUP_GCS_BUCKET).
- Azure Blob: SAS-token-authenticated REST
  (AZURE_STORAGE_ACCOUNT + AZURE_STORAGE_SAS_TOKEN + BACKUP_AZURE_CONTAINER).

All three speak the BackupBackend verbs, so the scheduler is oblivious to
which store holds the artifacts.
"""

from __future__ import annotations

import datetime
import hashlib
import hmac
import json
import urllib.error
import urllib.parse
import urllib.request
from typing import Optional

from weaviate_tpu_torch.modules.interface import BackupBackend, Module
from weaviate_tpu_torch.modules.provider import ModuleError

META_FILE = "backup_config.json"


def _sha256_hex(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


class S3BackupBackend(Module, BackupBackend):
    def __init__(self, bucket: str, access_key: str, secret_key: str,
                 region: str = "us-east-1", endpoint: str = "",
                 path_prefix: str = "", timeout: float = 120.0):
        if not bucket:
            raise ModuleError("backup-s3 requires BACKUP_S3_BUCKET")
        if not access_key or not secret_key:
            raise ModuleError(
                "backup-s3 requires AWS_ACCESS_KEY_ID and AWS_SECRET_ACCESS_KEY"
            )
        self.bucket = bucket
        self.access_key = access_key
        self.secret_key = secret_key
        self.region = region or "us-east-1"
        # explicit endpoint (minio etc.) => path-style; AWS => virtual host
        if endpoint:
            self.base = endpoint.rstrip("/") + "/" + bucket
            self.host = urllib.parse.urlparse(endpoint).netloc
            self.path_style = True
        else:
            self.host = f"{bucket}.s3.{self.region}.amazonaws.com"
            self.base = f"https://{self.host}"
            self.path_style = False
        self.prefix = path_prefix.strip("/")
        self.timeout = timeout

    @property
    def name(self) -> str:
        return "backup-s3"

    @property
    def module_type(self) -> str:
        return "backup"

    def meta(self) -> dict:
        return {"type": "backup", "bucket": self.bucket, "region": self.region}

    # -- SigV4 (AWS Signature Version 4, RFC-style canonical request) --------

    def _sign(self, method: str, path: str, payload: bytes) -> dict:
        now = datetime.datetime.now(datetime.timezone.utc)
        amz_date = now.strftime("%Y%m%dT%H%M%SZ")
        datestamp = now.strftime("%Y%m%d")
        payload_hash = _sha256_hex(payload)
        canonical_headers = (
            f"host:{self.host}\n"
            f"x-amz-content-sha256:{payload_hash}\n"
            f"x-amz-date:{amz_date}\n"
        )
        signed_headers = "host;x-amz-content-sha256;x-amz-date"
        canonical = "\n".join([
            method, path, "", canonical_headers, signed_headers, payload_hash,
        ])
        scope = f"{datestamp}/{self.region}/s3/aws4_request"
        string_to_sign = "\n".join([
            "AWS4-HMAC-SHA256", amz_date, scope, _sha256_hex(canonical.encode()),
        ])

        def _hmac(key: bytes, msg: str) -> bytes:
            return hmac.new(key, msg.encode(), hashlib.sha256).digest()

        k = _hmac(f"AWS4{self.secret_key}".encode(), datestamp)
        k = _hmac(k, self.region)
        k = _hmac(k, "s3")
        k = _hmac(k, "aws4_request")
        signature = hmac.new(k, string_to_sign.encode(), hashlib.sha256).hexdigest()
        return {
            "x-amz-date": amz_date,
            "x-amz-content-sha256": payload_hash,
            "Authorization": (
                f"AWS4-HMAC-SHA256 Credential={self.access_key}/{scope}, "
                f"SignedHeaders={signed_headers}, Signature={signature}"
            ),
        }

    def _key(self, backup_id: str, key: str) -> str:
        parts = [p for p in (self.prefix, backup_id, key) if p]
        return "/".join(parts)

    def _request(self, method: str, object_key: str, payload: bytes = b"") -> bytes:
        enc_key = urllib.parse.quote(object_key, safe="/-_.~")
        path = f"/{self.bucket}/{enc_key}" if self.path_style else f"/{enc_key}"
        url = f"{self.base}/{enc_key}"
        headers = self._sign(method, path, payload)
        req = urllib.request.Request(url, data=payload if method == "PUT" else None,
                                     method=method)
        for k, v in headers.items():
            req.add_header(k, v)
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise FileNotFoundError(object_key) from None
            raise ModuleError(
                f"s3 {method} {object_key}: HTTP {e.code}: "
                f"{e.read().decode('utf-8', 'replace')[:300]}"
            ) from None

    # -- BackupBackend --------------------------------------------------------

    def put_object(self, backup_id: str, key: str, data: bytes) -> None:
        self._request("PUT", self._key(backup_id, key), data)

    def get_object(self, backup_id: str, key: str) -> bytes:
        return self._request("GET", self._key(backup_id, key))

    def write_meta(self, backup_id: str, meta: dict) -> None:
        self.put_object(backup_id, META_FILE, json.dumps(meta).encode())

    def read_meta(self, backup_id: str) -> Optional[dict]:
        try:
            return json.loads(self.get_object(backup_id, META_FILE))
        except FileNotFoundError:
            return None

    def home_id(self, backup_id: str) -> str:
        return f"s3://{self.bucket}/{self._key(backup_id, '')}"


class GCSBackupBackend(Module, BackupBackend):
    def __init__(self, bucket: str, token: str,
                 base_url: str = "https://storage.googleapis.com",
                 timeout: float = 120.0):
        if not bucket or not token:
            raise ModuleError("backup-gcs requires BACKUP_GCS_BUCKET and BACKUP_GCS_TOKEN")
        self.bucket = bucket
        self.token = token
        self.base_url = base_url.rstrip("/")
        self.timeout = timeout

    @property
    def name(self) -> str:
        return "backup-gcs"

    @property
    def module_type(self) -> str:
        return "backup"

    def meta(self) -> dict:
        return {"type": "backup", "bucket": self.bucket}

    def _request(self, method: str, url: str, payload: Optional[bytes] = None) -> bytes:
        req = urllib.request.Request(url, data=payload, method=method)
        req.add_header("Authorization", f"Bearer {self.token}")
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise FileNotFoundError(url) from None
            raise ModuleError(f"gcs {method}: HTTP {e.code}") from None

    def put_object(self, backup_id: str, key: str, data: bytes) -> None:
        name = urllib.parse.quote(f"{backup_id}/{key}", safe="")
        self._request(
            "POST",
            f"{self.base_url}/upload/storage/v1/b/{self.bucket}/o"
            f"?uploadType=media&name={name}",
            data,
        )

    def get_object(self, backup_id: str, key: str) -> bytes:
        name = urllib.parse.quote(f"{backup_id}/{key}", safe="")
        return self._request(
            "GET", f"{self.base_url}/storage/v1/b/{self.bucket}/o/{name}?alt=media"
        )

    def write_meta(self, backup_id: str, meta: dict) -> None:
        self.put_object(backup_id, META_FILE, json.dumps(meta).encode())

    def read_meta(self, backup_id: str) -> Optional[dict]:
        try:
            return json.loads(self.get_object(backup_id, META_FILE))
        except FileNotFoundError:
            return None

    def home_id(self, backup_id: str) -> str:
        return f"gs://{self.bucket}/{backup_id}"


class AzureBackupBackend(Module, BackupBackend):
    def __init__(self, account: str, container: str, sas_token: str,
                 base_url: str = "", timeout: float = 120.0):
        if not account or not container or not sas_token:
            raise ModuleError(
                "backup-azure requires AZURE_STORAGE_ACCOUNT, "
                "BACKUP_AZURE_CONTAINER and AZURE_STORAGE_SAS_TOKEN"
            )
        self.container = container
        self.base_url = (base_url or f"https://{account}.blob.core.windows.net").rstrip("/")
        self.sas = sas_token.lstrip("?")
        self.timeout = timeout

    @property
    def name(self) -> str:
        return "backup-azure"

    @property
    def module_type(self) -> str:
        return "backup"

    def meta(self) -> dict:
        return {"type": "backup", "container": self.container}

    def _url(self, backup_id: str, key: str) -> str:
        blob = urllib.parse.quote(f"{backup_id}/{key}", safe="/-_.~")
        return f"{self.base_url}/{self.container}/{blob}?{self.sas}"

    def _request(self, method: str, url: str, payload: Optional[bytes] = None,
                 headers: Optional[dict] = None) -> bytes:
        req = urllib.request.Request(url, data=payload, method=method)
        for k, v in (headers or {}).items():
            req.add_header(k, v)
        safe_url = url.split("?")[0]  # never surface the SAS token
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise FileNotFoundError(safe_url) from None
            raise ModuleError(f"azure {method} {safe_url}: HTTP {e.code}") from None

    def put_object(self, backup_id: str, key: str, data: bytes) -> None:
        self._request("PUT", self._url(backup_id, key), data,
                      {"x-ms-blob-type": "BlockBlob"})

    def get_object(self, backup_id: str, key: str) -> bytes:
        return self._request("GET", self._url(backup_id, key))

    def write_meta(self, backup_id: str, meta: dict) -> None:
        self.put_object(backup_id, META_FILE, json.dumps(meta).encode())

    def read_meta(self, backup_id: str) -> Optional[dict]:
        try:
            return json.loads(self.get_object(backup_id, META_FILE))
        except FileNotFoundError:
            return None

    def home_id(self, backup_id: str) -> str:
        return f"{self.base_url}/{self.container}/{backup_id}"
