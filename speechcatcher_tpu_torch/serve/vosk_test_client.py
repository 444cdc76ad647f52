"""Test client for the websocket server (Vosk protocol; port of
``speechcatcher_tpu/serve/vosk_test_client.py``): sends the config message,
streams audio in 0.2 s chunks, sends eof, prints replies.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
from pathlib import Path

import numpy as np


async def run(uri: str, wav_path: Path, sample_rate: int = 16000):
    import websockets

    from speechcatcher_tpu_torch.utils.audio import convert_media

    data, rate = convert_media(wav_path)
    chunk = int(0.2 * rate)

    async with websockets.connect(uri) as ws:
        await ws.send(json.dumps({"config": {"sample_rate": rate}}))

        async def receiver():
            try:
                async for msg in ws:
                    print(msg)
            except Exception:
                pass

        recv_task = asyncio.create_task(receiver())
        for i in range(0, len(data), chunk):
            await ws.send(data[i : i + chunk].astype(np.int16).tobytes())
            await asyncio.sleep(0.2)  # real-time pacing
        await ws.send(json.dumps({"eof": 1}))
        await asyncio.sleep(2.0)
        recv_task.cancel()


def main(argv=None):
    parser = argparse.ArgumentParser(description="Vosk websocket test client")
    parser.add_argument("wav", help="audio file to stream")
    parser.add_argument("--uri", default="ws://localhost:2700")
    args = parser.parse_args(argv)
    asyncio.run(run(args.uri, Path(args.wav)))


if __name__ == "__main__":
    main()
