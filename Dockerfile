# Runtime image for red-gym-tpu (the reference ships an ubuntu+GL image for
# its pyglet renderer; this stack renders host-side with matplotlib, so a
# slim Python base suffices).  For an NVIDIA GPU install the CUDA variant.
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends \
    g++ \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/red-gym-tpu
COPY pyproject.toml README.md ./
COPY red_gym_tpu ./red_gym_tpu
COPY examples ./examples
COPY bench.py chip_smoke.py ./

# CPU jax by default; for an NVIDIA GPU use:  pip install -e ".[gpu,render]"
RUN pip install --no-cache-dir -e ".[render]"

CMD ["python", "examples/waypoint_follow.py", "--steps", "4500"]
