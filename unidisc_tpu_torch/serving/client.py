"""Minimal chat client for the serving endpoint (port of
``unidisc_tpu/serving/client.py``; standard library only).

A terminal REPL speaking the OpenAI chat schema; generated images are saved
as PNGs in the working directory.

Usage: python -m unidisc_tpu_torch.serving.client --url http://127.0.0.1:8000 \
           [--prompt "a photo of <mask:4>"] [--steps 32]
"""

from __future__ import annotations

import argparse
import base64
import json
import urllib.request


def chat(url: str, prompt: str, *, steps=None, seed=None, task="auto",
         timeout=600) -> dict:
    req = {"messages": [{"role": "user", "content": prompt}],
           "task": task}
    if steps:
        req["steps"] = steps
    if seed is not None:
        req["seed"] = seed
    data = json.dumps(req).encode()
    r = urllib.request.urlopen(urllib.request.Request(
        f"{url}/v1/chat/completions", data=data,
        headers={"Content-Type": "application/json"}), timeout=timeout)
    return json.load(r)


def render(resp: dict, save_prefix: str = "sample") -> None:
    content = resp["choices"][0]["message"]["content"]
    n_img = 0
    for item in content:
        if item["type"] == "text":
            print(item["text"])
        elif item["type"] == "image_url":
            b64 = item["image_url"]["url"].split(",", 1)[1]
            path = f"{save_prefix}_{n_img}.png"
            with open(path, "wb") as f:
                f.write(base64.b64decode(b64))
            print(f"[image saved: {path}]")
            n_img += 1
    print(f"[nfe: {resp.get('usage', {}).get('nfe')}]")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--url", default="http://127.0.0.1:8000")
    parser.add_argument("--prompt", default=None)
    parser.add_argument("--steps", type=int, default=None)
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument("--task", default="auto")
    args = parser.parse_args(argv)

    if args.prompt:
        render(chat(args.url, args.prompt, steps=args.steps, seed=args.seed,
                    task=args.task))
        return
    print("unidisc chat (ctrl-d to exit); <mask:N> marks infill spans")
    while True:
        try:
            prompt = input("> ")
        except EOFError:
            break
        if prompt.strip():
            render(chat(args.url, prompt, steps=args.steps, seed=args.seed,
                        task=args.task))


if __name__ == "__main__":
    main()
