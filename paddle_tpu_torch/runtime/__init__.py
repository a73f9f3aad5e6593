"""The request plane: wire frames (`frames`) and the RPC client with
reconnect, endpoint failover and wire negotiation (`master`)."""
