FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ && \
    rm -rf /var/lib/apt/lists/*

WORKDIR /app
COPY . /app
RUN pip install --no-cache-dir jax numpy pandas jsonschema scipy \
    matplotlib && \
    pip install --no-cache-dir -e . --no-deps

ENTRYPOINT ["chromosight-tpu"]
CMD ["--help"]
