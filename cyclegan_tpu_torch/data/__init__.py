"""Host-side data helpers for serving (numpy + PIL copies of the JAX
package's transforms, palette and class-name tables)."""
