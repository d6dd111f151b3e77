"""The volunteer swarm: transport, DHT, membership, matchmaking, streaming
aggregation and the sync averager (copied from the JAX package's
``swarm/``), and the volunteer lifecycle."""
