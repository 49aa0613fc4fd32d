"""The port's OpenAI HTTP surface on the tiny model (CPU), and the import
rule: no port module loads jax or anything of dynamo_tpu, none loads
ml_dtypes (the KV tiers' bf16 and e4m3 entries are torch tensors), and none
loads safetensors, sentencepiece, tokenizers, transformers, jinja2 or
huggingface_hub at import (the functions that need the last three import
them)."""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

from dynamo_tpu_torch.engine import EngineConfig, TorchEngine
from dynamo_tpu_torch.http import HttpService, ModelManager
from dynamo_tpu_torch.llm import ByteTokenizer
from dynamo_tpu_torch.llm.openai_engine import OpenAIWorkerEngine
from dynamo_tpu_torch.models.config import ModelConfig

REPO = Path(__file__).resolve().parent.parent


async def _http(port: int, method: str, path: str, body=None):
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    data = b"" if body is None else json.dumps(body).encode()
    writer.write(
        f"{method} {path} HTTP/1.1\r\nHost: x\r\nConnection: close\r\n"
        f"Content-Length: {len(data)}\r\n\r\n".encode() + data
    )
    await writer.drain()
    raw = await reader.read()
    writer.close()
    await writer.wait_closed()
    head, _, payload = raw.partition(b"\r\n\r\n")
    status = int(head.split()[1])
    if b"chunked" in head.lower():
        out = b""
        while payload:
            size, _, rest = payload.partition(b"\r\n")
            n = int(size, 16)
            if n == 0:
                break
            out, payload = out + rest[:n], rest[n + 2:]
        payload = out
    return status, payload


def test_http_service_serves_the_tiny_model(run):
    engine = TorchEngine(
        EngineConfig(model=ModelConfig.tiny(dtype="float32"), num_blocks=64,
                     block_size=4, max_batch_size=4, max_context=128),
        params=None, seed=0, device="cpu",
    )
    manager = ModelManager()
    worker = OpenAIWorkerEngine(ByteTokenizer(), engine)
    manager.add_chat_model("tiny", worker)
    manager.add_completion_model("tiny", worker)
    svc = HttpService(manager, host="127.0.0.1", port=0)

    async def main():
        await svc.start()
        try:
            status, body = await _http(svc.port, "GET", "/v1/models")
            assert status == 200
            assert [m["id"] for m in json.loads(body)["data"]] == ["tiny"]
            req = {"model": "tiny", "prompt": "hello paged world",
                   "max_tokens": 6, "temperature": 0.0}
            status, body = await _http(svc.port, "POST", "/v1/completions", req)
            assert status == 200
            full = json.loads(body)
            assert full["usage"]["completion_tokens"] == 6
            assert full["choices"][0]["finish_reason"] == "length"
            status, body = await _http(svc.port, "POST", "/v1/completions",
                                       dict(req, stream=True))
            assert status == 200
            events = [line[6:] for line in body.decode().split("\n\n")
                      if line.startswith("data: ")]
            assert events[-1] == "[DONE]"
            text = "".join(json.loads(e)["choices"][0]["text"]
                           for e in events[:-1])
            # greedy: the stream spells the same text as the folded answer
            assert text == full["choices"][0]["text"]
            status, body = await _http(svc.port, "POST", "/v1/chat/completions", {
                "model": "tiny", "max_tokens": 3,
                "messages": [{"role": "user", "content": "hi"}]})
            assert status == 200 and json.loads(body)["choices"][0]["message"]
            status, _ = await _http(svc.port, "POST", "/v1/completions",
                                    dict(req, model="nope"))
            assert status == 404
            status, body = await _http(svc.port, "GET", "/metrics")
            assert status == 200
            assert ('dynamo_tpu_torch_http_service_requests_total{model="tiny",'
                    'endpoint="completions",status="success"} 2') in body.decode()
        finally:
            await svc.close()
            await engine.close()

    run(main())


def test_port_imports_neither_jax_nor_the_jax_package():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts)
        for p in (REPO / "dynamo_tpu_torch").rglob("*.py")
    )
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
        "'dynamo_tpu', 'safetensors', 'sentencepiece', 'tokenizers', "
        "'transformers', 'jinja2', 'huggingface_hub', 'ml_dtypes')]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert len(modules) > 20
    assert {"dynamo_tpu_torch.models.mla",
            "dynamo_tpu_torch.ops.mla_attention",
            "dynamo_tpu_torch.models.quant",
            "dynamo_tpu_torch.ops.moe_gmm",
            # the speculative path's modules
            "dynamo_tpu_torch.ops.kv_cache_update",
            "dynamo_tpu_torch.ops.sampling",
            "dynamo_tpu_torch.models.llama",
            "dynamo_tpu_torch.engine.engine",
            # the checkpoint path: loader, tokenizers, model resolution
            "dynamo_tpu_torch.models.weights",
            "dynamo_tpu_torch.llm.sp_model",
            "dynamo_tpu_torch.llm.tokenizer",
            "dynamo_tpu_torch.llm.hub",
            "dynamo_tpu_torch.launch.dynamo_run",
            # the KV tiers: the codec, the stores, the block copies
            "dynamo_tpu_torch.utils.dtypes",
            "dynamo_tpu_torch.engine.kvquant",
            "dynamo_tpu_torch.engine.offload",
            "dynamo_tpu_torch.ops.block_copy",
            "dynamo_tpu_torch.kv_router.costmodel",
            # the KV transfer plane, disaggregation and the fleet pull
            "dynamo_tpu_torch.resilience.faultpoints",
            "dynamo_tpu_torch.ops.kv_rearrange",
            "dynamo_tpu_torch.disagg.protocols",
            "dynamo_tpu_torch.disagg.queue",
            "dynamo_tpu_torch.disagg.router",
            "dynamo_tpu_torch.disagg.transfer",
            "dynamo_tpu_torch.disagg.worker",
            "dynamo_tpu_torch.kv_router.publisher",
            # migration and graceful drain
            "dynamo_tpu_torch.resilience.policy",
            "dynamo_tpu_torch.resilience.migration",
            "dynamo_tpu_torch.resilience.drain"} <= set(modules)
