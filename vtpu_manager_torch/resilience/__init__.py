"""Retries, breakers and fault injection for the node agents (see the JAX
package's resilience/)."""
